"""Streaming training read: event store → columnar host arrays.

The port's copy of the generic path of the JAX package's
``data/pipeline.py``:

- :func:`iter_columnar` — stream the store's ``find()`` iterator into
  fixed-size columnar chunks (ids + values), never holding more than
  ``chunk_size`` Event objects;
- :func:`read_interactions` — the two-pass reader for (user, item[,
  rating]) training data: pass 1 builds the id vocabularies in first-seen
  order, pass 2 re-streams yielding index-mapped chunks
  (:class:`InteractionData`);
- :func:`read_event_groups` — the multi-event two-pass reader (the
  Universal Recommender's shape): several named streams over ONE shared
  vocabulary pair, demuxed by event name;
- :func:`subset_columnar` — a fold's rows with both vocabularies trimmed
  to the entities present (the eval-fold cold-entity rule);
- :class:`DevicePrefetcher` — double-buffered host → device transfer
  over an iterator of host arrays (the streaming trainer's input).

The native columnar scan and its snapshot cache are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.utils.bimap import BiMap


def iter_columnar(
    events: Iterator,
    chunk_size: int = 65536,
    value_fn: Optional[Callable[[Any], Optional[float]]] = None,
) -> Iterator[Tuple[List[str], List[str], np.ndarray]]:
    """Group an event iterator into columnar chunks.

    Yields ``(entity_ids, target_ids, values)`` with lists of length ≤
    ``chunk_size``; events without a target entity are skipped, and
    ``value_fn`` returning None drops the event (malformed rating).
    """
    ents: List[str] = []
    tgts: List[str] = []
    vals: List[float] = []
    for e in events:
        # falsy (None or "") — the columnar scans treat an empty-string
        # target as no target, and the paths must agree
        if not e.target_entity_id:
            continue
        v = 1.0
        if value_fn is not None:
            maybe = value_fn(e)
            if maybe is None:
                continue
            v = maybe
        ents.append(e.entity_id)
        tgts.append(e.target_entity_id)
        vals.append(v)
        if len(ents) == chunk_size:
            yield ents, tgts, np.asarray(vals, np.float32)
            ents, tgts, vals = [], [], []
    if ents:
        yield ents, tgts, np.asarray(vals, np.float32)


class InteractionData:
    """Index-mapped interaction data with its vocabularies.

    ``chunks()`` re-streams the store in columnar chunks (beyond-RAM
    path); ``arrays()`` concatenates them (fits-in-RAM path).
    """

    def __init__(self, user_ids: BiMap, item_ids: BiMap,
                 chunk_factory: Callable[[], Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]],
                 n_events: int) -> None:
        self.user_ids = user_ids
        self.item_ids = item_ids
        self._chunk_factory = chunk_factory
        self.n_events = n_events

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (user_idx, item_idx, value) int32/int32/f32 chunks."""
        return self._chunk_factory()

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        us, is_, vs = [], [], []
        for u, i, v in self.chunks():
            us.append(u)
            is_.append(i)
            vs.append(v)
        if not us:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
        return np.concatenate(us), np.concatenate(is_), np.concatenate(vs)


def _vocab_add(vocab: Dict[str, int], keys) -> None:
    """First-seen dense index assignment (shared vocabulary pass)."""
    for k in keys:
        if k not in vocab:
            vocab[k] = len(vocab)


def _map_chunk(users: Dict[str, int], items: Dict[str, int],
               ents, tgts) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map one chunk's string ids through the vocabularies. Events
    ingested AFTER the vocabulary pass may carry unknown ids (training
    against a live store re-runs find() per pass); they are skipped,
    not crashed on — the next train picks them up. Returns
    ``(user_idx, item_idx, keep_mask)`` so callers can mask parallel
    value columns."""
    u = np.asarray([users.get(x, -1) for x in ents], np.int32)
    i = np.asarray([items.get(x, -1) for x in tgts], np.int32)
    keep = (u >= 0) & (i >= 0)
    return u[keep], i[keep], keep


def read_interactions(
    find: Callable[[], Iterator],
    chunk_size: int = 65536,
    value_fn: Optional[Callable[[Any], Optional[float]]] = None,
) -> InteractionData:
    """Two-pass streaming read of (user, item[, value]) interactions.

    ``find`` is a zero-argument callable returning a FRESH event
    iterator (it runs twice: vocabulary pass + data pass), e.g.
    ``lambda: event_store.find(app_name, ...)``. Memory is O(chunk +
    vocabulary) regardless of event-log size.
    """
    users: Dict[str, int] = {}
    items: Dict[str, int] = {}
    n_events = 0
    for ents, tgts, _vals in iter_columnar(find(), chunk_size, value_fn):
        _vocab_add(users, ents)
        _vocab_add(items, tgts)
        n_events += len(ents)
    user_ids = BiMap(users)
    item_ids = BiMap(items)

    def chunk_factory():
        for ents, tgts, vals in iter_columnar(find(), chunk_size, value_fn):
            u, i, keep = _map_chunk(users, items, ents, tgts)
            yield u, i, vals[keep]

    return InteractionData(user_ids, item_ids, chunk_factory, n_events)


def read_event_groups(
    find: Callable[[], Iterator],
    names: Sequence[str],
    chunk_size: int = 65536,
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], BiMap, BiMap]:
    """Multi-event streaming read with ONE SHARED vocabulary pair —
    the Universal-Recommender shape: several named event streams over
    the same user/item spaces, index-mapped consistently.

    ``find`` is a zero-argument callable returning a FRESH iterator
    over ALL the named events (two combined scans total — vocabulary
    pass + data pass — demuxed by ``e.event``; per-name finds would
    cost 2·N scans of the log). Returns ``({name: (user_idx,
    item_idx)}, user_ids, item_ids)`` with ids assigned in
    encounter order. Memory is O(chunk + vocabulary) transient plus
    the 8 B/event columnar outputs."""
    wanted = set(names)
    users: Dict[str, int] = {}
    items: Dict[str, int] = {}
    for e in find():
        if not e.target_entity_id or e.event not in wanted:
            continue
        if e.entity_id not in users:
            users[e.entity_id] = len(users)
        if e.target_entity_id not in items:
            items[e.target_entity_id] = len(items)
    user_ids = BiMap(users)
    item_ids = BiMap(items)

    bufs: Dict[str, Tuple[List[str], List[str]]] = \
        {n: ([], []) for n in names}
    parts: Dict[str, Tuple[list, list]] = {n: ([], []) for n in names}

    def flush(name: str) -> None:
        ents, tgts = bufs[name]
        if ents:
            u, i, _keep = _map_chunk(users, items, ents, tgts)
            parts[name][0].append(u)
            parts[name][1].append(i)
            bufs[name] = ([], [])

    for e in find():
        if not e.target_entity_id or e.event not in wanted:
            continue
        ents, tgts = bufs[e.event]
        ents.append(e.entity_id)
        tgts.append(e.target_entity_id)
        if len(ents) == chunk_size:
            flush(e.event)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for n in names:
        flush(n)
        us, is_ = parts[n]
        out[n] = ((np.concatenate(us) if us else np.zeros(0, np.int32)),
                  (np.concatenate(is_) if is_ else np.zeros(0, np.int32)))
    return out, user_ids, item_ids


def subset_columnar(
    mask: np.ndarray,
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    user_ids: BiMap,
    item_ids: BiMap,
    *values: np.ndarray,
) -> tuple:
    """Rows where ``mask`` holds, with both vocabularies TRIMMED to the
    entities present and the index columns re-mapped to the trimmed
    maps. The eval-fold primitive: a training fold must NOT know the
    held-out fold's cold users/items (they would score 0.0 instead of
    being skipped by the OptionAverageMetric convention).

    Returns ``(user_idx, item_idx, user_ids, item_ids, *values)`` with
    each extra ``values`` column masked alongside.
    """
    uu, ii = user_idx[mask], item_idx[mask]
    uniq_u = np.unique(uu)
    uniq_i = np.unique(ii)
    lut_u = np.full(len(user_ids), -1, np.int32)
    lut_u[uniq_u] = np.arange(len(uniq_u), dtype=np.int32)
    lut_i = np.full(len(item_ids), -1, np.int32)
    lut_i[uniq_i] = np.arange(len(uniq_i), dtype=np.int32)
    u_inv = user_ids.inverse()
    i_inv = item_ids.inverse()
    return (lut_u[uu], lut_i[ii],
            BiMap({u_inv[int(u)]: int(j) for j, u in enumerate(uniq_u)}),
            BiMap({i_inv[int(i)]: int(j) for j, i in enumerate(uniq_i)}),
            *(v[mask] for v in values))


PREFETCH_DEPTH = 2


class DevicePrefetcher:
    """Double-buffered host → device transfer over an iterator.

    A background thread pulls the next item (a numpy array or a tuple of
    them) and, for a CUDA ``device``, copies it into pinned host buffers
    and on to the card ``non_blocking`` on a side CUDA stream, while the
    consumer computes on the current item. The consumer's stream waits on
    that copy before an item is handed out, so it is safe to use at once.
    With ``PREFETCH_DEPTH`` items in flight the device never waits on host
    decode unless the host is genuinely slower end to end. ``device`` is CUDA
    unless the caller names another (raising without a card); on the
    CPU the items pass through as the host arrays they are.

    Iterate it, or use as a context manager to guarantee the thread
    shuts down on early exit. Exceptions from the source re-raise at the
    consumer.
    """

    _DONE = object()

    def __init__(self, source: Iterator, device: Any = None) -> None:
        import torch

        from predictionio_tpu_torch.utils.device import resolve_device

        self._source = source
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pio-prefetch")
        self._thread.start()

    def _put_device(self, item):
        """(item on the device, the copy's CUDA event or None)."""
        import torch

        if self._stream is None:
            return item, None

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = (tuple(put(a) for a in item) if isinstance(item, tuple)
                   else put(item))
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                item = self._put_device(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(self._DONE)
        except BaseException as e:  # propagate to the consumer
            # retried like the success path: dropping the exception when
            # the queue is momentarily full would end the thread with
            # neither the error nor the DONE sentinel, and the consumer
            # would wait forever
            while not self._stop.is_set():
                try:
                    self._q.put(e, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        got = self._q.get()
        if got is self._DONE:
            raise StopIteration
        if isinstance(got, BaseException):
            raise got
        item, event = got
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            # the caching allocator must not hand these blocks to the
            # side stream again before the consumer's work on them ends
            for t in (item if isinstance(item, tuple) else (item,)):
                t.record_stream(stream)
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so the producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
