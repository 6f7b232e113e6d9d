"""Event Server: the ingestion REST API on :7070.

The port's copy of the JAX package's ``server/event_server.py``, with the
reference's API contract (reference: [U] data/.../api/EventServer.scala):

- ``POST /events.json?accessKey=K[&channel=C]`` → 201 ``{"eventId": …}``
- ``POST /batch/events.json`` — ≤ 50 events, per-item status array
- ``GET  /events.json`` — filters: startTime/untilTime/entityType/
  entityId/event/targetEntityType/targetEntityId/limit/reversed
- ``GET|DELETE /events/{id}.json``
- ``GET /`` → ``{"status": "alive"}``
- ``GET /stats.json`` (when started with stats=True)
- ``POST|GET /webhooks/{connector}.json`` — 3rd-party payload translation

Auth: access key via ``accessKey`` query param or ``Authorization``
header (Bearer, or Basic with the key as user name); keys may restrict
permitted event names. Channel by name via ``channel`` param (must
exist). With ``ingest_batching`` single-event POSTs are group-committed
(``server/ingest.py``): a 201 still comes only after the commit, a full
queue answers 429 and an open storage breaker 503, both with
``Retry-After``.

The operations surface is the JAX server's: ``GET /health`` (ok, or
degraded while the ingest breaker is open or the queue is full, with the
``ingest`` block), ``GET /metrics``, ``GET /metrics/history`` (its own
scraped history), ``GET /traces``, the access log, TLS (``ssl_context``,
by default from ``PIO_SSL_CERT_PATH``/``PIO_SSL_KEY_PATH``) and the
request spans (``storage.insert``, ``storage.insert_batch``,
``ingest.submit``).

Tenancy: each app's events are charged to its own token bucket
(``quotas.json`` next to the event data, written by ``app quota``,
hot-reloaded); an app over its quota gets its OWN 429 with
``Retry-After``, counted in ``pio_tenant_quota_rejected_total{app}``,
and other apps never see it. ``/health`` names the policy file in
``tenantQuotas``. Plugins (``core/plugins.py``, ``PIO_PLUGINS``): an
``input_blocker`` refuses an event with 403, and ``input_sniffer`` sees
every event after its commit. Incident capture (``incident_dir``): the
ingest storage breaker opening writes a postmortem bundle, and
``serve_forever`` installs the SIGQUIT and crash handlers. On the
EVENTLOG backend ``quotas.json``'s ``writer_shards`` sets each app's
writer shards (``set_shard_policy``), and ``segment_maintenance`` starts
the background compaction and cold-tier thread.

Replication (``replication``, a ``server/repl_server.ReplNode``): every
event-data route passes the node's gate first (a follower answers 307 to
the leader, a fenced ex-leader 503), the node mounts its ``/repl/*``
wire on this server, and a write that the node's fence refuses
(``FencedWriteError``) gets 503 with ``Retry-After`` and lands nothing.
``serve_forever`` starts the node's election and stops it (a leader
releases the lease) around serving.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import math
import threading
import time
import urllib.parse
import uuid
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import (
    Event,
    EventValidationError,
    parse_event_time,
    utcnow,
)
from predictionio_tpu_torch.core.plugins import event_server_plugins
from predictionio_tpu_torch.data.replication import FencedWriteError
from predictionio_tpu_torch.data.webhooks import get_connector
from predictionio_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
    traces_handler,
)
from predictionio_tpu_torch.server.ingest import (
    IngestOverload,
    StorageUnavailable,
    WriteCoalescer,
)
from predictionio_tpu_torch.server.tenancy import TenantQuotas
from predictionio_tpu_torch.storage.meta import meta_epoch
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils import tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY, build_info
from predictionio_tpu_torch.utils.timeseries import (
    TimeSeriesStore,
    history_payload,
    scaled_tiers,
    scrape_loop,
)

BATCH_LIMIT = 50
DEFAULT_FIND_LIMIT = 20


class AuthCache:
    """TTL cache for the per-request meta-store lookups (access key and
    channel by name): every POST otherwise pays one or two SQL reads
    before touching event storage.

    Entries expire after ``ttl`` seconds, and the WHOLE cache drops the
    moment a key or channel mutation in this process bumps the meta
    epoch (:func:`~predictionio_tpu_torch.storage.meta.meta_epoch`), so a
    revocation in the same process is effective at once. Mutations by
    another process are seen only after the TTL; ``auth_cache_ttl=0``
    turns the cache off.

    Negative results are cached too (a flood of bad keys must not turn
    into a flood of SQL reads); the cache is size-capped so that
    attacker-chosen keys cannot grow it without bound."""

    MAX_ENTRIES = 4096

    def __init__(self, meta, ttl: float = 30.0) -> None:
        self._meta = meta
        self.ttl = ttl
        self._epoch = meta_epoch()
        self._lock = threading.Lock()
        self._keys: Dict[str, Tuple[float, Any]] = {}
        self._channels: Dict[Tuple[int, str], Tuple[float, Any]] = {}
        self._m = REGISTRY.counter(
            "pio_authcache_total", "Auth cache lookups", ("result",))

    def _fresh(self, cache: Dict, key) -> Tuple[bool, Any]:
        """Must hold the lock. Returns (hit, value)."""
        epoch = meta_epoch()
        if epoch != self._epoch:
            self._keys.clear()
            self._channels.clear()
            self._epoch = epoch
            return False, None
        ent = cache.get(key)
        if ent is not None and ent[0] > time.monotonic():
            return True, ent[1]
        return False, None

    def _put(self, cache: Dict, key, value) -> None:
        with self._lock:
            if len(cache) >= self.MAX_ENTRIES:
                cache.clear()
            cache[key] = (time.monotonic() + self.ttl, value)

    def get_access_key(self, key: str):
        with self._lock:
            hit, val = self._fresh(self._keys, key)
        if hit:
            self._m.inc(("hit",))
            return val
        self._m.inc(("miss",))
        ak = self._meta.get_access_key(key)
        self._put(self._keys, key, ak)
        return ak

    def get_channel_by_name(self, app_id: int, name: str):
        with self._lock:
            hit, val = self._fresh(self._channels, (app_id, name))
        if hit:
            self._m.inc(("hit",))
            return val
        self._m.inc(("miss",))
        ch = self._meta.get_channel_by_name(app_id, name)
        self._put(self._channels, (app_id, name), ch)
        return ch


class Stats:
    """Per-app event-type/status counters since server start
    (reference: Stats/StatsActor behind /stats.json)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.start_time = utcnow()
        self._counts: Counter = Counter()  # (app_id, event_name, status)

    def record(self, app_id: int, event_name: str, status: int) -> None:
        with self._lock:
            self._counts[(app_id, event_name, status)] += 1

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            per_app: Dict[int, List[Dict[str, Any]]] = {}
            for (app_id, name, status), n in sorted(self._counts.items()):
                per_app.setdefault(app_id, []).append(
                    {"event": name, "status": status, "count": n})
        return {
            "startTime": self.start_time.isoformat(timespec="milliseconds"),
            "appStats": [
                {"appId": app_id, "events": evs} for app_id, evs in per_app.items()
            ],
        }


class EventServer:
    def __init__(
        self,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = 7070,
        stats: bool = False,
        plugins: Optional[List[Any]] = None,
        ssl_context: Optional[Any] = None,
        bind_retries: int = 3,
        bind_retry_sec: float = 1.0,
        ingest_batching: bool = False,
        ingest_max_batch: int = 512,
        ingest_queue_depth: int = 4096,
        auth_cache_ttl: float = 30.0,
        durable_acks: bool = False,
        access_log: bool = False,
        segment_maintenance: bool = False,
        tenant_quotas: Optional[Any] = None,
        scrape_interval: float = 10.0,
        incident_dir: Optional[str] = None,
        replication: Optional[Any] = None,
    ) -> None:
        self.storage = storage or get_storage()
        # replicated event plane (server/repl_server.ReplNode): when set,
        # every event-data handler passes through its gate (followers 307
        # to the leader, fenced ex-leaders shed 503) and the node mounts
        # its /repl/* wire on this router
        self.repl = replication
        # per-app QoS policy (quotas.json next to the event data, written
        # by `app quota`): ingest token buckets. The zero-config default
        # is unlimited, so single-tenant deployments are unchanged.
        if isinstance(tenant_quotas, TenantQuotas):
            self.quotas = tenant_quotas
        elif tenant_quotas:
            self.quotas = TenantQuotas(str(tenant_quotas))
        else:
            self.quotas = TenantQuotas.for_home(self.storage.config.home)
        if hasattr(self.storage.events, "set_shard_policy"):
            # writer shards of the native event log: the policy names how
            # many active writer shards each app's namespaces fan appends
            # across (quotas.json's writer_shards; no-op elsewhere)
            self.storage.events.set_shard_policy(self.quotas.writer_shards)
        if segment_maintenance and hasattr(self.storage.events,
                                           "start_maintenance"):
            # background compaction of sealed segments and cold-tier
            # shipping (EVENTLOG only)
            self.storage.events.start_maintenance()
        if durable_acks:
            # 201 then means on disk (fsync), not just committed to the
            # page cache; with ingest batching the coalescer amortizes
            # the sync over each group commit
            self.storage.events.set_durable(True)
        self.stats = Stats() if stats else None
        self.plugins = plugins if plugins is not None else event_server_plugins()
        self._m_events = REGISTRY.counter(
            "pio_events_ingested_total", "Events accepted/rejected",
            ("app_id", "status"))
        self._m_insert = REGISTRY.histogram(
            "pio_event_insert_seconds", "Single-event insert latency")
        self._m_quota = REGISTRY.counter(
            "pio_tenant_quota_rejected_total",
            "Events refused by the app's own ingest quota", ("app",))
        #: process identity on pio_build_info
        self.instance_uid = uuid.uuid4().hex[:12]
        build_info(self.instance_uid)
        #: local metrics history (GET /metrics/history), scraped from
        #: the registry every scrape_interval by a background task
        self.scrape_interval = max(0.05, scrape_interval)
        self.tsdb = TimeSeriesStore(
            REGISTRY, tiers=scaled_tiers(self.scrape_interval))
        self._ingest = (WriteCoalescer(self.storage.events,
                                       max_batch=ingest_max_batch,
                                       max_queue=ingest_queue_depth)
                        if ingest_batching else None)
        # incident flight recorder: breaker-open / crash / SIGQUIT
        # postmortem bundles under <home>/incidents (utils/incidents)
        self.incidents = None
        if incident_dir:
            from predictionio_tpu_torch.utils.incidents import (
                IncidentCapturer,
                IncidentStore,
                default_incident_dir,
            )

            if incident_dir == "auto":
                incident_dir = default_incident_dir(self.storage.config.home)
            self.incidents = IncidentCapturer(
                IncidentStore(incident_dir), process="events")
            self.incidents.add_source("health", self._health_doc)
            self.incidents.set_history(self.tsdb, lambda: [
                "pio_events_ingested_total", "pio_event_insert_seconds_count",
                "pio_tenant_quota_rejected_total",
                "pio_circuit_breaker_state",
            ])
            if self._ingest is not None:
                self._ingest.breaker.on_open = (
                    lambda name: self.incidents.trigger(
                        "breaker-open", {"breaker": name}))
        self._auth_cache = (AuthCache(self.storage.meta, ttl=auth_cache_ttl)
                            if auth_cache_ttl > 0 else None)
        router = Router()
        router.route("GET", "/", self._status)
        router.route("GET", "/health", self._health)
        router.route("GET", "/metrics", self._metrics)
        router.route("GET", "/metrics/history", self._metrics_history)
        router.route("GET", "/traces", traces_handler)
        router.route("POST", "/events.json", self._post_event)
        router.route("GET", "/events.json", self._get_events)
        router.route("POST", "/batch/events.json", self._post_batch)
        router.route("GET", "/events/{eid}.json", self._get_event)
        router.route("DELETE", "/events/{eid}.json", self._delete_event)
        router.route("GET", "/stats.json", self._get_stats)
        router.route("POST", "/webhooks/{connector}.json", self._webhook)
        router.route("GET", "/webhooks/{connector}.json", self._webhook_probe)
        if self.repl is not None:
            self.repl.attach(self, router)
        if ssl_context is None:
            from predictionio_tpu_torch.server.ssl_config import (
                ssl_context_from_env,
            )

            ssl_context = ssl_context_from_env()
        # retry a busy port for a few seconds, while a previous server on
        # it shuts down
        self.http = HTTPServer(router, host, port,
                               ssl_context=ssl_context,
                               bind_retries=bind_retries,
                               bind_retry_sec=bind_retry_sec,
                               access_log=access_log,
                               server_name="events")

    # -- auth ------------------------------------------------------------------

    def _auth(self, req: Request) -> Tuple[Optional[Tuple[int, Optional[int], List[str]]], Optional[Response]]:
        """Returns ((app_id, channel_id, allowed_events), None) or (None, error)."""
        key = req.param("accessKey")
        if not key:
            auth = req.headers.get("authorization", "")
            # reference SDKs use HTTP basic with the key as username; also
            # accept a bare "Bearer <key>"
            if auth.startswith("Bearer "):
                key = auth[7:].strip()
            elif auth.startswith("Basic "):
                try:
                    key = base64.b64decode(auth[6:]).decode().split(":")[0]
                except Exception:
                    key = None
        if not key:
            return None, Response.json(
                {"message": "Missing accessKey."}, status=401)
        meta = self._auth_cache or self.storage.meta
        ak = meta.get_access_key(key)
        if ak is None:
            return None, Response.json(
                {"message": "Invalid accessKey."}, status=401)
        channel_id: Optional[int] = None
        channel = req.param("channel")
        if channel:
            ch = meta.get_channel_by_name(ak.app_id, channel)
            if ch is None:
                return None, Response.json(
                    {"message": f"Invalid channel {channel!r}."}, status=400)
            channel_id = ch.id
        return (ak.app_id, channel_id, ak.events), None

    def _repl_gate(self, req: Request) -> Optional[Response]:
        """Replication role gate for event-data routes: None when this
        node serves, else the follower's 307-to-leader redirect or the
        fenced ex-leader's 503. Observability routes are never gated."""
        if self.repl is None:
            return None
        return self.repl.gate(req)

    # -- handlers --------------------------------------------------------------

    async def _status(self, req: Request) -> Response:
        return Response.json({"status": "alive"})

    def _health_doc(self) -> Dict[str, Any]:
        """Sync health snapshot for incident bundles: ingest queue and
        breaker state without going through the event loop."""
        doc: Dict[str, Any] = {"instance": self.instance_uid}
        if self._ingest is not None:
            doc["ingest"] = {
                "queueDepth": self._ingest.depth,
                "breaker": self._ingest.breaker.state,
                "rejected": self._ingest.rejected,
                "breakerRejected": self._ingest.breaker_rejected,
            }
        return doc

    async def _health(self, req: Request) -> Response:
        """Liveness and readiness: ``ok`` when storage is reachable,
        ``degraded`` (still 200: a supervisor must not restart a server
        that sheds correctly) while the ingest storage breaker is open or
        the queue is full."""
        body: Dict[str, Any] = {"status": "ok"}
        if self.quotas.path:
            body["tenantQuotas"] = self.quotas.path
        if self._ingest is not None:
            breaker = self._ingest.breaker
            body["ingest"] = {
                "queueDepth": self._ingest.depth,
                "breaker": breaker.state,
                "rejected": self._ingest.rejected,
                "breakerRejected": self._ingest.breaker_rejected,
                # who filled the queue (accepted, not yet committed)
                "queuedByApp": {str(a): n for a, n in
                                sorted(self._ingest.queued_by_app.items())},
            }
            if breaker.state != "closed":
                body["status"] = "degraded"
                body["reason"] = "ingest storage circuit breaker open"
            elif self._ingest.depth >= self._ingest.max_queue:
                body["status"] = "degraded"
                body["reason"] = "ingest queue at capacity"
        return Response.json(body)

    async def _metrics(self, req: Request) -> Response:
        return Response.text(REGISTRY.render(),
                             content_type="text/plain; version=0.0.4")

    async def _metrics_history(self, req: Request) -> Response:
        status, payload = history_payload(
            self.tsdb, req.param("series") or "", req.param("window") or "")
        return Response.json(payload, status=status)

    @staticmethod
    def _throttled(status: int, message: str, retry_after: float) -> Response:
        """Shed response: a machine-usable ``retryAfterSec`` float in the
        body plus the RFC 9110 integral ``Retry-After`` header, ceil'd so
        that the hint is never shorter than the wait."""
        body = {"message": message,
                "retryAfterSec": round(max(0.0, retry_after), 3)}
        resp = Response.json(body, status=status)
        resp.headers["Retry-After"] = str(max(1, math.ceil(retry_after)))
        return resp

    def _quota_gate(self, app_id: int, n: int) -> Optional[Response]:
        """Charge ``n`` events to the app's ingest bucket; a refusal is
        that tenant's OWN 429 — other apps' submits never see it."""
        ok, retry_after = self.quotas.admit(app_id, n)
        if ok:
            return None
        self._m_quota.inc((app_id,))
        self._m_events.inc((app_id, 429))
        return self._throttled(
            429, f"app {app_id} over its ingest quota "
                 f"({n} event(s) refused)", retry_after)

    @staticmethod
    def _created(eid: str) -> Response:
        # constant-shape 201 body without a json.dumps on the hot path;
        # generated ids are hex, but a client-supplied id might need
        # real JSON escaping
        if eid.isalnum():
            return Response(status=201,
                            body=b'{"eventId":"%s"}' % eid.encode())
        return Response.json({"eventId": eid}, status=201)

    def _prepare_one(
        self, obj: Any, app_id: int, channel_id: Optional[int],
        allowed: List[str],
    ) -> Tuple[Optional[Event], Optional[Tuple[int, Dict[str, Any]]]]:
        """Parse/validate/authorize one event body WITHOUT inserting.
        Returns (event, None) or (None, (status, error body)); error
        statuses are counted here."""
        try:
            ev = Event.from_json(obj)
        except EventValidationError as e:
            self._m_events.inc((app_id, 400))
            return None, (400, {"message": str(e)})
        if allowed and ev.event not in allowed:
            self._m_events.inc((app_id, 403))
            return None, (403, {"message": f"event {ev.event!r} not permitted "
                                           "by this key"})
        for p in self.plugins:
            verdict = p.input_blocker(ev, app_id, channel_id)
            if verdict is not None:
                self._m_events.inc((app_id, 403))
                return None, (403, {"message": verdict})
        return ev, None

    def _finish_one(self, ev: Event, app_id: int, channel_id: Optional[int],
                    elapsed: float) -> None:
        """Post-commit accounting shared by every insert path."""
        for p in self.plugins:
            p.input_sniffer(ev, app_id, channel_id)
        if self.stats:
            self.stats.record(app_id, ev.event, 201)
        self._m_events.inc((app_id, 201))
        self._m_insert.observe(elapsed)

    def _insert_one(self, obj: Any, app_id: int, channel_id: Optional[int],
                    allowed: List[str]) -> Tuple[int, Dict[str, Any]]:
        t0 = time.perf_counter()
        ev, err = self._prepare_one(obj, app_id, channel_id, allowed)
        if err is not None:
            return err
        with tracing.span("storage.insert", app_id=app_id):
            eid = self.storage.events.insert(ev, app_id, channel_id)
        self._finish_one(ev, app_id, channel_id, time.perf_counter() - t0)
        return 201, {"eventId": eid}

    async def _ingest_obj(self, obj: Any, app_id: int,
                          channel_id: Optional[int],
                          allowed: List[str]) -> Response:
        """One event body → Response, through the group-commit
        coalescer when enabled (ack only after the commit returns),
        else the per-event insert path."""
        deny = self._quota_gate(app_id, 1)
        if deny is not None:
            return deny
        if self._ingest is None:
            try:
                status, body = await asyncio.to_thread(
                    self._insert_one, obj, app_id, channel_id, allowed)
            except FencedWriteError as e:
                # demotion raced this write: the bytes never landed, and
                # an honest 503 sends the client to the new leader
                self._m_events.inc((app_id, 503))
                return self._throttled(503, str(e), 1.0)
            if status == 201:
                return self._created(body["eventId"])
            return Response.json(body, status=status)
        t0 = time.perf_counter()
        # parse/authorize inline: pure Python, no storage round trip —
        # keeps the hot path free of a to_thread hop per request
        ev, err = self._prepare_one(obj, app_id, channel_id, allowed)
        if err is not None:
            status, body = err
            return Response.json(body, status=status)
        try:
            # the submit span covers queue wait and group commit; the
            # commit's detached ingest.commit span lists this trace id
            async with tracing.span("ingest.submit", app_id=app_id,
                                    queue_depth=self._ingest.depth):
                eid = await self._ingest.submit(ev, app_id, channel_id)
        except IngestOverload as e:
            # the Retry-After is computed from queue depth over the
            # measured drain rate, not a constant
            self._m_events.inc((app_id, 429))
            return self._throttled(429, str(e), e.retry_after)
        except StorageUnavailable as e:
            # storage breaker open: fail fast, don't queue doomed work
            self._m_events.inc((app_id, 503))
            return self._throttled(503, str(e), e.retry_after)
        except FencedWriteError as e:
            # this node was demoted while the event sat in the queue: the
            # append was refused before any byte landed
            self._m_events.inc((app_id, 503))
            return self._throttled(503, str(e), 1.0)
        except Exception as e:
            self._m_events.inc((app_id, 500))
            return Response.json(
                {"message": f"event insert failed: {e}"}, status=500)
        self._finish_one(ev, app_id, channel_id, time.perf_counter() - t0)
        return self._created(eid)

    async def _post_event(self, req: Request) -> Response:
        deny = self._repl_gate(req)
        if deny is not None:
            return deny
        auth, err = self._auth(req)
        if err:
            return err
        app_id, channel_id, allowed = auth
        return await self._ingest_obj(req.json(), app_id, channel_id, allowed)

    async def _post_batch(self, req: Request) -> Response:
        deny = self._repl_gate(req)
        if deny is not None:
            return deny
        auth, err = self._auth(req)
        if err:
            return err
        app_id, channel_id, allowed = auth
        payload = req.json()
        if not isinstance(payload, list):
            return Response.json({"message": "batch body must be a JSON array"},
                                 status=400)
        if len(payload) > BATCH_LIMIT:
            return Response.json(
                {"message": f"Batch request must have at most {BATCH_LIMIT} events"},
                status=400)
        deny = self._quota_gate(app_id, len(payload))
        if deny is not None:
            return deny

        def run() -> List[Dict[str, Any]]:
            t0 = time.perf_counter()
            prepared = [self._prepare_one(obj, app_id, channel_id, allowed)
                        for obj in payload]
            if prepared and all(err is None for _, err in prepared):
                # every event valid and permitted: ONE insert_batch, one
                # storage commit for the whole payload; a failure falls
                # back below so that the per-item status array stays
                # accurate
                events = [ev for ev, _ in prepared]
                try:
                    with tracing.span("storage.insert_batch",
                                      app_id=app_id, records=len(events)):
                        ids = self.storage.events.insert_batch(
                            events, app_id, channel_id)
                except FencedWriteError as e:
                    # demoted mid-batch: nothing landed; every item gets
                    # the same honest shed status
                    self._m_events.inc((app_id, 503))
                    return [{"status": 503, "message": str(e)}
                            for _ in events]
                except Exception:
                    pass
                else:
                    per_event = (time.perf_counter() - t0) / len(events)
                    for ev in events:
                        self._finish_one(ev, app_id, channel_id, per_event)
                    return [{"status": 201, "eventId": eid} for eid in ids]
            # mixed validity (or batch-commit failure): event by event,
            # so that one bad item cannot poison its siblings' statuses
            results = []
            for ev, err in prepared:
                if err is not None:
                    status, body = err
                    results.append({"status": status, **body})
                    continue
                t1 = time.perf_counter()
                try:
                    eid = self.storage.events.insert(ev, app_id, channel_id)
                except FencedWriteError as e:
                    self._m_events.inc((app_id, 503))
                    results.append({"status": 503, "message": str(e)})
                    continue
                except Exception as e:
                    self._m_events.inc((app_id, 500))
                    results.append({"status": 500,
                                    "message": f"event insert failed: {e}"})
                    continue
                self._finish_one(ev, app_id, channel_id, time.perf_counter() - t1)
                results.append({"status": 201, "eventId": eid})
            return results

        return Response.json(await asyncio.to_thread(run))

    async def _get_events(self, req: Request) -> Response:
        deny = self._repl_gate(req)
        if deny is not None:
            return deny
        auth, err = self._auth(req)
        if err:
            return err
        app_id, channel_id, _ = auth
        try:
            start = parse_event_time(req.param("startTime")) if req.param("startTime") else None
            until = parse_event_time(req.param("untilTime")) if req.param("untilTime") else None
        except EventValidationError as e:
            return Response.json({"message": str(e)}, status=400)
        limit_s = req.param("limit")
        try:
            limit = int(limit_s) if limit_s else DEFAULT_FIND_LIMIT
        except ValueError:
            return Response.json({"message": f"invalid limit {limit_s!r}"}, status=400)
        event_name = req.param("event")

        def run():
            return [e.to_json() for e in self.storage.events.find(
                app_id, channel_id,
                start_time=start, until_time=until,
                entity_type=req.param("entityType"),
                entity_id=req.param("entityId"),
                event_names=[event_name] if event_name else None,
                target_entity_type=req.param("targetEntityType"),
                target_entity_id=req.param("targetEntityId"),
                limit=(None if limit == -1 else limit),
                reversed=req.param("reversed") in ("true", "1"),
            )]

        return Response.json(await asyncio.to_thread(run))

    async def _get_event(self, req: Request) -> Response:
        deny = self._repl_gate(req)
        if deny is not None:
            return deny
        auth, err = self._auth(req)
        if err:
            return err
        app_id, channel_id, _ = auth
        ev = await asyncio.to_thread(
            self.storage.events.get, req.path_params["eid"], app_id, channel_id)
        if ev is None:
            return Response.json({"message": "Not Found"}, status=404)
        return Response.json(ev.to_json())

    async def _delete_event(self, req: Request) -> Response:
        deny = self._repl_gate(req)
        if deny is not None:
            return deny
        auth, err = self._auth(req)
        if err:
            return err
        app_id, channel_id, _ = auth
        ok = await asyncio.to_thread(
            self.storage.events.delete, req.path_params["eid"], app_id, channel_id)
        if not ok:
            return Response.json({"message": "Not Found"}, status=404)
        return Response.json({"message": "Found"})

    async def _get_stats(self, req: Request) -> Response:
        if self.stats is None:
            return Response.json(
                {"message": "stats not enabled; start eventserver with --stats"},
                status=404)
        return Response.json(self.stats.to_json())

    async def _webhook(self, req: Request) -> Response:
        deny = self._repl_gate(req)
        if deny is not None:
            return deny
        auth, err = self._auth(req)
        if err:
            return err
        app_id, channel_id, allowed = auth
        name = req.path_params["connector"]
        conn = get_connector(name)
        if conn is None:
            return Response.json(
                {"message": f"unknown webhook connector {name!r}"}, status=404)
        try:
            if conn.kind == "form":
                form = {k: v[0] for k, v in
                        urllib.parse.parse_qs(req.body.decode()).items()}
                obj = conn.to_event_json(form)
            else:
                obj = conn.to_event_json(req.json())
        except Exception as e:
            return Response.json({"message": f"connector error: {e}"}, status=400)
        return await self._ingest_obj(obj, app_id, channel_id, allowed)

    async def _webhook_probe(self, req: Request) -> Response:
        _, err = self._auth(req)
        if err:
            return err
        name = req.path_params["connector"]
        if get_connector(name) is None:
            return Response.json(
                {"message": f"unknown webhook connector {name!r}"}, status=404)
        return Response.json({"connector": name, "status": "ready"})

    # -- lifecycle -------------------------------------------------------------

    async def serve_forever(self) -> None:
        if self.incidents is not None:
            from predictionio_tpu_torch.utils.incidents import (
                install_crash_handlers,
            )

            install_crash_handlers(self.incidents)
        if self.repl is not None:
            # one election attempt decides leader vs follower; the
            # role's background threads keep it honest from here
            self.repl.start()
        scraper = asyncio.create_task(
            scrape_loop(self.tsdb, self.scrape_interval),
            name="pio-events-tsdb")
        try:
            await self.http.serve_forever()
        finally:
            scraper.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await scraper
            if self.repl is not None:
                # a graceful leader releases the lease here so a
                # follower promotes without waiting out the TTL
                self.repl.stop()
            if self._ingest is not None:
                # drain: everything accepted before shutdown commits —
                # a 201 promised durability, so the queue must land
                await self._ingest.aclose()

    def run(self) -> None:
        asyncio.run(self.serve_forever())
