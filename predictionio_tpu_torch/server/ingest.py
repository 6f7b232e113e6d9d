"""Group-commit write coalescer for the event server's ingest path.

The port's copy of the JAX package's ``server/ingest.py``. Every
backend's ``insert_batch`` already amortizes the expensive part of a
write — one SQL ``executemany`` + COMMIT (``data/events.py``) — but
concurrent single-event POSTs never used it: each request paid a full
per-event commit. The reference's HBase backend got batching for free
from client-side put buffering; this layer is the framework's
equivalent, server side, with a durability guarantee the client buffer
never had.

Design mirrors :class:`~predictionio_tpu_torch.server.batching.MicroBatcher`
(the query-path coalescer):

- **No timed wait on the hot path.** Batches form naturally from
  service time: while a commit runs, new arrivals queue; the next
  collect drains EVERYTHING queued (up to ``max_batch``). A lone
  event pays ~0 extra latency.
- **One commit per (app, channel) group** per dispatch — namespaces
  are separate tables, so a drained batch is grouped before the
  backend call.
- **Ack after commit.** A request's future resolves only once its
  group's ``insert_batch`` has returned, so a 201 still means the
  event is as durable as the backend makes a committed write.
- **Per-event failure isolation.** A failed group commit re-runs its
  events one by one (the MicroBatcher isolation move): each caller
  sees their OWN error; siblings of a poison event still land.
- **Bounded queue with backpressure.** Past ``max_queue`` pending
  events, ``submit`` raises :class:`IngestOverload`; the HTTP layer
  maps it to ``429`` + ``Retry-After`` instead of letting the queue
  grow without bound under a traffic spike. The Retry-After is
  *computed* — queue depth over the measured commit drain rate — so
  clients back off proportionally to actual congestion.
- **Storage circuit breaker.** Repeated group-commit failures trip
  the ``ingest_storage`` breaker open; further submits fail
  IMMEDIATELY with :class:`StorageUnavailable` (HTTP layer → ``503``
  + ``Retry-After``) instead of queueing events that are doomed to
  time out against a down backend. Half-open trial commits close it
  again once storage recovers. Poison events do NOT trip it: a failed
  group whose per-event rerun succeeds proves storage is up.
- **Clean drain on shutdown.** ``aclose()`` refuses new work, lets
  the committer finish everything already accepted, then commits any
  remainder itself — no accepted (let alone acked) event is lost.

Enable with ``EventServer(ingest_batching=True)`` or
``cli eventserver --ingest-batching``.

Each commit is a detached ``ingest.commit`` span that links the trace
ids of the requests it acknowledges, and the coalescer counts the queued
events per app (``queued_by_app``, on the event server's ``/health``).

Each commit, and each isolated re-run of one event, passes the
``ingest.commit`` fault site first: an armed error there is a storage
outage (the commit fails, nothing lands, and enough failures open the
breaker).

A commit refused by a fenced ex-leader (``FencedWriteError``, the
replicated event plane) is no storage outage: the breaker stays closed,
no event is re-run alone, and every caller of the batch sees the fence.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import time
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.replication import FencedWriteError
from predictionio_tpu_torch.utils import faults, tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY
from predictionio_tpu_torch.utils.resilience import CircuitBreaker

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

#: queue sentinel: aclose() pushes it behind everything already
#: accepted, so the committer drains in arrival order then exits
_STOP = object()


class IngestOverload(Exception):
    """Ingest queue at capacity — shed load instead of queueing."""

    def __init__(self, depth: int, limit: int,
                 retry_after: float = 1.0) -> None:
        super().__init__(
            f"ingest queue full ({depth}/{limit} events pending)")
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after


class StorageUnavailable(Exception):
    """The storage breaker is open: event storage is known-down, fail
    fast (HTTP layer → 503 + Retry-After) instead of queueing work."""

    def __init__(self, retry_after: float) -> None:
        super().__init__(
            "event storage unavailable (circuit breaker open, "
            f"retry after {retry_after:.1f}s)")
        self.retry_after = max(1.0, retry_after)


class WriteCoalescer:
    """Order-preserving group-commit front for an
    :class:`~predictionio_tpu_torch.data.events.EventStore`."""

    def __init__(self, store, max_batch: int = 512,
                 max_queue: int = 4096) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.store = store
        self.max_batch = max_batch
        self.max_queue = max_queue
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: Optional[asyncio.Task] = None
        self._executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self._closed = False
        self.submitted = 0    # events accepted into the queue
        self.batches = 0      # group commits issued
        self.isolations = 0   # failed groups re-run event-by-event
        self.rejected = 0     # submits refused by backpressure
        self.breaker_rejected = 0  # submits refused by the open breaker
        #: queued events per app (accepted, not yet dispatched to a
        #: commit): when the cap trips, this names the app that filled it
        self.queued_by_app: Dict[int, int] = {}
        #: EWMA of commit throughput (events/sec) — denominator for
        #: the computed 429 Retry-After
        self._drain_ewma = 0.0
        #: repeated commit failures → open → fast 503s. Decoupled use
        #: (admit at submit, record at commit) — see CircuitBreaker doc.
        self.breaker = CircuitBreaker(
            "ingest_storage", failure_threshold=8, reset_timeout=5.0)
        self._m_depth = REGISTRY.gauge(
            "pio_ingest_queue_depth", "Events waiting for a group commit")
        self._m_batch = REGISTRY.histogram(
            "pio_ingest_batch_events", "Events per group commit",
            buckets=_BATCH_BUCKETS)
        self._m_commit = REGISTRY.histogram(
            "pio_ingest_commit_seconds", "Group-commit latency")
        self._m_coalesced = REGISTRY.counter(
            "pio_ingest_coalesced_events_total",
            "Events that shared their commit with at least one other")
        self._m_rejected = REGISTRY.counter(
            "pio_ingest_rejected_total",
            "Submits refused before queueing, by app and reason",
            ("app", "reason"))

    # -- plumbing --------------------------------------------------------------

    #: commit threads: groups for DIFFERENT (app, channel) namespaces
    #: are different tables, so they may commit concurrently (the
    #: SQLite store serialises its writes under one lock). Within one
    #: namespace commits stay ordered — _commit awaits all groups of a
    #: dispatch before the next dispatch starts.
    _COMMIT_WORKERS = 4

    def _get_executor(self) -> concurrent.futures.ThreadPoolExecutor:
        # dedicated pool: commits must never wait behind the shared
        # to_thread pool, which blocked request handlers can saturate
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._COMMIT_WORKERS,
                thread_name_prefix="pio-ingest")
        return self._executor

    def _ensure_worker(self) -> None:
        if self._worker is None or self._worker.done():
            self._worker = asyncio.get_running_loop().create_task(self._run())

    @property
    def depth(self) -> int:
        return self._queue.qsize()

    @property
    def drain_rate(self) -> float:
        """Measured commit throughput, events/sec (0 until observed)."""
        return self._drain_ewma

    def overload_retry_after(self) -> float:
        """Honest backoff hint for a queue-full 429: time to drain the
        current depth at the measured rate, clamped to [0.05s, 30s].
        Before any commit has been observed, 1s."""
        if self._drain_ewma <= 0:
            return 1.0
        return min(30.0, max(0.05, self._queue.qsize() / self._drain_ewma))

    # -- submit ----------------------------------------------------------------

    async def submit(self, event: Event, app_id: int,
                     channel_id: Optional[int] = None) -> str:
        """Enqueue one validated event; resolves to its eventId once
        the group commit that contains it has returned (or raises the
        per-event storage error)."""
        if self._closed:
            raise RuntimeError("ingest coalescer is closed")
        if not self.breaker.admit():
            self.breaker_rejected += 1
            self._m_rejected.inc((app_id, "breaker"))
            raise StorageUnavailable(self.breaker.retry_after())
        if self._queue.qsize() >= self.max_queue:
            self.rejected += 1
            self._m_rejected.inc((app_id, "queue_full"))
            raise IngestOverload(self._queue.qsize(), self.max_queue,
                                 self.overload_retry_after())
        self._ensure_worker()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.submitted += 1
        self.queued_by_app[app_id] = self.queued_by_app.get(app_id, 0) + 1
        # hot path: put_nowait (the queue is unbounded — depth limiting
        # happened above) skips a coroutine round trip per event, and
        # the depth gauge is refreshed once per dispatch in _collect().
        # The submitter's trace id rides along: the commit serves many
        # requests' traces, so its span links to them
        self._queue.put_nowait(
            (app_id, channel_id, event, fut, tracing.current_trace_id()))
        return await fut

    # -- committer -------------------------------------------------------------

    async def _collect(self) -> Tuple[List[tuple], bool]:
        """One dispatch's worth: block for the first item, yield once
        so ready handlers enqueue, then take everything queued (up to
        ``max_batch``). Returns (items, stop_seen). No timed wait —
        see module docstring."""
        first = await self._queue.get()
        if first is _STOP:
            return [], True
        items = [first]
        stop = False
        # quiescence loop: yield to ready handlers, drain what they
        # enqueued, repeat while the queue keeps growing. Still no
        # timed wait — sleep(0) adds zero idle time — but requests
        # that are already parsed and mid-handler make this dispatch
        # instead of the next one. Bounded by max_batch and by the
        # natural cap of in-flight requests (a client waiting for its
        # ack can't enqueue another event).
        while len(items) < self.max_batch:
            await asyncio.sleep(0)
            grew = False
            while len(items) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                items.append(nxt)
                grew = True
            if stop or not grew:
                break
        self._m_depth.set(self._queue.qsize())
        return items, stop

    async def _run(self) -> None:
        while True:
            items, stop = await self._collect()
            if items:
                await self._commit(items)
            if stop:
                return

    def _insert_batch_guarded(self, events: List[Event], app_id: int,
                              channel_id: Optional[int]) -> List[str]:
        faults.inject("ingest.commit")
        return self.store.insert_batch(events, app_id, channel_id)

    def _insert_one_guarded(self, event: Event, app_id: int,
                            channel_id: Optional[int]) -> str:
        faults.inject("ingest.commit")
        return self.store.insert(event, app_id, channel_id)

    async def _commit(self, items: List[tuple]) -> None:
        """Group by (app, channel), one ``insert_batch`` per group.
        Groups are independent namespaces (separate tables), so a
        multi-namespace dispatch commits them concurrently on the
        dedicated pool."""
        groups: Dict[Tuple[int, Optional[int]], List[tuple]] = {}
        for app_id, channel_id, event, fut, trace_id in items:
            groups.setdefault((app_id, channel_id), []).append(
                (event, fut, trace_id))
        if len(groups) == 1:
            ((app_id, channel_id), pairs), = groups.items()
            await self._commit_group(app_id, channel_id, pairs)
            return
        await asyncio.gather(*(
            self._commit_group(app_id, channel_id, pairs)
            for (app_id, channel_id), pairs in groups.items()))

    async def _commit_group(self, app_id: int, channel_id: Optional[int],
                            pairs: List[tuple]) -> None:
        loop = asyncio.get_running_loop()
        ex = self._get_executor()
        events = [e for e, _, _ in pairs]
        left = self.queued_by_app.get(app_id, 0) - len(pairs)
        if left > 0:
            self.queued_by_app[app_id] = left
        else:
            self.queued_by_app.pop(app_id, None)
        # the commit serves MANY requests' traces: a detached root span
        # that links every submitter's trace id
        links = sorted({t for _, _, t in pairs if t})[:64]
        self.batches += 1
        t0 = time.perf_counter()
        with tracing.detached_span("ingest.commit", app_id=app_id,
                                   records=len(events),
                                   link_traces=links) as sp:
            try:
                ids = await loop.run_in_executor(
                    ex, self._insert_batch_guarded, events, app_id,
                    channel_id)
                if len(ids) != len(events):
                    raise RuntimeError(
                        f"insert_batch returned {len(ids)} ids for "
                        f"{len(events)} events")
            except FencedWriteError as e:
                # leadership lost, not a storage outage: the breaker
                # must stay closed (storage is fine — WE are fenced)
                # and per-item isolation is pointless (every retry
                # refuses identically); every caller sees the fence
                sp.set_error(f"fenced: {e}")
                for _, fut, _ in pairs:
                    if not fut.done():
                        fut.set_exception(e)
                return
            except Exception as e:
                self.breaker.record_failure()
                sp.set_error(f"{type(e).__name__}: {e}")
                if len(pairs) == 1:
                    if not pairs[0][1].done():
                        pairs[0][1].set_exception(e)
                    return
                # a poison event must not fail its commit siblings, and
                # each caller must see their OWN error — re-run alone
                self.isolations += 1
                sp.set_attr("isolated", True)
                for event, fut, _ in pairs:
                    if fut.done():
                        continue
                    try:
                        eid = await loop.run_in_executor(
                            ex, self._insert_one_guarded, event, app_id,
                            channel_id)
                    except Exception as single_e:
                        if not fut.done():
                            fut.set_exception(single_e)
                    else:
                        # storage demonstrably works — the group failure
                        # was a poison event, not an outage
                        self.breaker.record_success()
                        if not fut.done():
                            fut.set_result(eid)
                return
        self.breaker.record_success()
        elapsed = time.perf_counter() - t0
        rate = len(events) / max(elapsed, 1e-6)
        self._drain_ewma = (rate if self._drain_ewma <= 0
                            else 0.3 * rate + 0.7 * self._drain_ewma)
        self._m_commit.observe(elapsed,
                               exemplar=links[0] if links else None)
        self._m_batch.observe(len(events))
        if len(events) > 1:
            self._m_coalesced.inc(n=len(events))
        for (_, fut, _), eid in zip(pairs, ids):
            if not fut.done():
                fut.set_result(eid)

    # -- lifecycle -------------------------------------------------------------

    async def aclose(self) -> None:
        """Refuse new submits, commit everything already accepted,
        release the executor. The coalescer is reusable afterwards
        (next ``submit`` restarts worker + executor) so a server that
        stops and serves again keeps working."""
        self._closed = True
        try:
            worker = self._worker
            if worker is not None and not worker.done():
                await self._queue.put(_STOP)
                await worker
            self._worker = None
            # leftovers are only possible if the worker had previously
            # died — drain them here so no accepted event is dropped
            leftovers: List[tuple] = []
            while True:
                try:
                    item = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if item is not _STOP:
                    leftovers.append(item)
            while leftovers:
                chunk = leftovers[:self.max_batch]
                leftovers = leftovers[self.max_batch:]
                await self._commit(chunk)
            self._m_depth.set(0)
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
        finally:
            self._closed = False
