"""Engine Server: query serving on :8000, on the card.

Reference: [U] core/.../workflow/CreateServer.scala (SURVEY.md §3.2),
and the JAX package's ``server/engine_server.py``. Routes:

- ``POST /queries.json``   → prediction JSON (the p50-critical path)
- ``GET  /``               → engine status JSON
- ``GET  /health``         → ok / degraded / not-ready probe
- ``GET  /reload``         → hot-swap to the latest COMPLETED instance
- ``GET  /stop``           → shut the server down
- ``GET  /metrics``        → Prometheus text exposition
- ``GET  /metrics/history`` → the local metrics history (``?series=&window=``)
- ``GET  /traces``         → recent spans from the tracer's ring
- ``POST /feedback.json``  → attribute a click or rating to the arm that
  served its ``prId`` (with ``variants``)
- ``GET  /variants``       → the resident variant set and its online stats
- ``POST /variants/weights`` → re-split traffic, probe-then-apply
- ``GET  /plugins.json`` + ``/plugins/{name}/{path}`` → plugin surface

The model stays resident on the serving device; prediction runs on a
worker thread (or, with ``batching``, on the micro-batcher's dispatch
thread) so the asyncio loop never blocks on the device. Errors answer
JSON: 400 for a malformed query, 500 for a server fault, and 503 with
``Retry-After`` while the AOT warmup has not finished warming the
serving programs (on the card that includes building the kernel).

The resilience contract is the JAX server's:

- **Deadline**: with ``query_timeout_ms`` set, a query that outlives its
  budget answers ``504``; a routing hop's ``X-PIO-Deadline-Ms`` tightens
  it.
- **Load shedding**: with ``max_inflight`` set, requests past the cap
  answer ``503`` + ``Retry-After`` before any await, weighted-fair per
  ``X-PIO-App`` (``server/tenancy.FairInflight``, weights from
  ``quotas.json``).
- **Hardened /reload**: reloads are serialized; the candidate is built
  on the server's own device, its bucket ladder warmed off the hot path,
  and it must answer a probe query (the last successfully served one)
  before the swap. A failed warm-up or probe keeps the last-good engine
  (``rolled_back``); a candidate that does not load is ``refused``.

- **Feedback breaker**: with ``feedback`` on, each served prediction
  (with its ``prId``) goes back to the event store as a ``predict`` event
  on a dedicated two-thread executor (at most 256 in flight; past that
  feedback drops, counted; a worker delivers what has queued up, at most
  50 events, in one send), through the ``feedback_sink`` breaker: a
  down Event Server trips it open and feedback then drops fast, counted
  as ``breaker_open``, while serving answers 200.

Multi-model serving (``variants=...``): several registry generations
stay resident on the server's device at once (``server/variants.py``),
each query goes to an arm by a deterministic sticky weighted split (or
the ``X-PIO-Variant`` request header), the serving arm comes back in
``X-PIO-Variant``, the micro-batcher dispatches one padded batch per arm
through that arm's factors, feedback is attributed per arm
(``server/variant_metrics.py``) and ``/reload?variant=`` swaps one arm.
Without variants, feedback, plugins or incident capture, a query pays a
loop over the empty plugin list and one ``if self.feedback`` test.

Incident capture (``incident_dir``): an opening breaker writes a
postmortem bundle (``utils/incidents.py``), and ``serve_forever``
installs the SIGQUIT and crash handlers.

The fleet router (``server/router.py``) pushes a manifest's variant pins
to ``POST /variants/weights`` and sends its synthetic prober's canary
with ``X-PIO-Probe``, which skips the fair admission and the variant
scoreboard. The continuous trainer's online gate
(``server/trainer.py``, ``--gate online``) reads this server's
``pio_variant_*`` series from ``/metrics``.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import datetime as _dt
import json
import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.core.plugins import engine_server_plugins
from predictionio_tpu_torch.core.workflow import DeployedEngine, prepare_deploy
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
    traces_handler,
)
from predictionio_tpu_torch.storage.models import find_gen
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils import faults, tracing
from predictionio_tpu_torch.utils.device import resolve_device
from predictionio_tpu_torch.utils.metrics import REGISTRY, build_info
from predictionio_tpu_torch.utils.resilience import (
    OPEN,
    CircuitBreaker,
    CircuitOpenError,
)
from predictionio_tpu_torch.utils.timeseries import (
    TimeSeriesStore,
    history_payload,
    scaled_tiers,
    scrape_loop,
)


class EngineServer:
    #: the most feedback events one send delivers (the Event Server's
    #: batch limit)
    _FEEDBACK_BATCH = 50

    def __init__(
        self,
        engine_factory: Optional[str] = None,
        instance_id: Optional[str] = None,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = 8000,
        variant_id: str = "",
        feedback: bool = False,
        feedback_app_name: Optional[str] = None,
        feedback_url: Optional[str] = None,
        feedback_access_key: Optional[str] = None,
        feedback_channel: Optional[str] = None,
        event_sink: Optional[Any] = None,
        plugins: Optional[List[Any]] = None,
        ssl_context: Optional[Any] = None,
        bind_retries: int = 3,
        bind_retry_sec: float = 1.0,
        batching: bool = False,
        batch_max: int = 64,
        batch_wait_ms: float = 0.0,
        aot_buckets: Optional[str] = None,
        aot_topk: int = 16,
        query_timeout_ms: float = 0.0,
        max_inflight: int = 0,
        reload_probe: bool = True,
        require_engine: bool = True,
        access_log: bool = False,
        variants: Optional[str] = None,
        variant_salt: str = "pio",
        tenant_quotas: Optional[Any] = None,
        scrape_interval: float = 10.0,
        incident_dir: Optional[str] = None,
        device=None,
    ) -> None:
        # resolved first: with no card and no CPU request the server
        # raises even when require_engine=False would let it come up
        self.device = resolve_device(device)
        self.storage = storage or get_storage()
        self.engine_factory = engine_factory
        self.variant_id = variant_id
        self.feedback = feedback or bool(feedback_url) or event_sink is not None
        self.feedback_app_name = feedback_app_name
        self._event_sink = event_sink
        if self._event_sink is None and feedback_url:
            # the reference contract: feedback goes through the Event
            # Server's authenticated HTTP API (SURVEY.md §3.2), the only
            # path that works when event storage is remote to this host
            from predictionio_tpu_torch.server.eventsink import HTTPEventSink

            if not feedback_access_key:
                raise ValueError("feedback_url requires feedback_access_key")
            self._event_sink = HTTPEventSink(
                feedback_url, feedback_access_key, feedback_channel)
        self.plugins = plugins if plugins is not None else engine_server_plugins()
        self.deployed: Optional[DeployedEngine] = None
        self._load_error: Optional[str] = None
        if not variants:
            try:
                self.deployed = prepare_deploy(
                    engine_factory=engine_factory, instance_id=instance_id,
                    storage=self.storage, variant_id=variant_id,
                    device=self.device)
            except Exception as e:
                # with require_engine=False the server still comes up (and
                # reports not-ready), so that ops can deploy before the
                # first train and /reload the model in later
                if require_engine:
                    raise
                self._load_error = f"{type(e).__name__}: {e}"
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        #: replica identity, surfaced on /health: a router that sees the
        #: instance id change knows it talks to a restarted process
        self.instance_uid = uuid.uuid4().hex[:12]
        self.start_epoch = time.time()
        #: EWMA of successful-query handler latency (loop thread only);
        #: feeds the Retry-After hint on shed 503s
        self._lat_ewma = 0.0
        self.query_count = 0
        self.query_timeout = max(0.0, query_timeout_ms) / 1e3
        self.max_inflight = max(0, max_inflight)
        self.reload_probe = reload_probe
        #: loop-thread-only in-flight request count; admission reads it
        #: before any await
        self._inflight = 0
        # per-app weighted-fair admission under max_inflight: an app over
        # its weighted share of the cap sheds first (no X-PIO-App header:
        # one shared bucket, the global cap)
        from predictionio_tpu_torch.server.tenancy import (
            FairInflight,
            TenantQuotas,
        )

        if isinstance(tenant_quotas, TenantQuotas):
            self.quotas = tenant_quotas
        elif tenant_quotas:
            self.quotas = TenantQuotas(str(tenant_quotas))
        else:
            self.quotas = TenantQuotas.for_home(self.storage.config.home)
        self._fair = FairInflight(self.max_inflight,
                                  weight_of=self.quotas.weight)
        self._counts_lock = threading.Lock()
        self._last_good_query: Optional[Any] = None
        self._reload_lock: Optional[asyncio.Lock] = None
        self.reload_generation = 0
        #: outcome of the most recent /reload ({"outcome": "promoted" |
        #: "rolled_back" | "refused", ...})
        self.last_swap: Optional[Dict[str, Any]] = None
        self._m_queries = REGISTRY.counter(
            "pio_engine_queries_total", "Queries served", ("status",))
        self._m_latency = REGISTRY.histogram(
            "pio_engine_query_seconds", "Query latency (handler, seconds)",
            labelnames=("status",))
        self._m_feedback = REGISTRY.counter(
            "pio_engine_feedback_total", "Feedback events sent", ("status",))
        self._m_shed = REGISTRY.counter(
            "pio_engine_shed_total",
            "Queries shed by the max-inflight cap", ("app",))
        self._m_deadline = REGISTRY.counter(
            "pio_engine_deadline_exceeded_total",
            "Queries that outlived query_timeout_ms")
        self._m_reloads = REGISTRY.counter(
            "pio_engine_reloads_total", "Reload attempts", ("result",))
        self._m_reload_gen = REGISTRY.gauge(
            "pio_engine_reload_generation",
            "Engine swaps served since start (0 = the deploy-time model)")
        self._m_reload_gen.set(0)
        build_info(self.instance_uid)
        #: local metrics history (GET /metrics/history), scraped from the
        #: registry every scrape_interval by a background task
        self.scrape_interval = max(0.05, scrape_interval)
        self.tsdb = TimeSeriesStore(
            REGISTRY, tiers=scaled_tiers(self.scrape_interval))
        #: a down Event Server must fail FAST after a few sink errors,
        #: not tie both feedback workers up in 5 s connect timeouts
        self._sink_breaker = CircuitBreaker(
            "engine_feedback_sink", failure_threshold=5, reset_timeout=10.0)
        self._breakers: Dict[str, CircuitBreaker] = {
            "feedback_sink": self._sink_breaker}
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
                IncidentStore(incident_dir), process="engine")
            self.incidents.add_source("health", self._health_doc)
            self.incidents.set_history(self.tsdb, lambda: [
                "pio_engine_queries_total",
                "pio_engine_query_seconds_bucket",
                "pio_engine_query_seconds_count",
                "pio_engine_shed_total", "pio_engine_feedback_total",
                "pio_circuit_breaker_state",
            ])
            for b in self._breakers.values():
                b.on_open = lambda name: self.incidents.trigger(
                    "breaker-open", {"breaker": name})
        self._feedback_pool = None
        self._feedback_inflight = 0
        self._feedback_queue: collections.deque = collections.deque()
        #: AOT warmup: warm the serving program for every padded batch
        #: bucket at deploy time (and the candidate's at /reload), so no
        #: query shape <= max_batch meets a cold program on the hot path
        self._warmup = None
        ladder = None
        if aot_buckets is not None:
            from predictionio_tpu_torch.server.aot import AOTWarmup, BucketLadder

            ladder = BucketLadder.parse(aot_buckets, batch_max)
            # an explicit ladder defines its own max batch: collecting
            # past the top bucket would dispatch an unwarmed shape
            batch_max = ladder.max_batch
            if not variants:
                self._warmup = AOTWarmup(ladder, ks=(aot_topk,))
                if self.deployed is not None:
                    self._warmup.start(self.deployed)
        #: multi-model serving: the resident variant set and its online
        #: scoreboard. Each arm gets its OWN AOTWarmup over the shared
        #: ladder; same-geometry arms adopt each other's cached programs,
        #: so residency costs device memory, not builds.
        self._mux = None
        self._scoreboard = None
        if variants:
            from predictionio_tpu_torch.server.variant_metrics import (
                VariantScoreboard,
            )
            from predictionio_tpu_torch.server.variants import VariantSet

            warm_factory = None
            if ladder is not None:
                def warm_factory(_ladder=ladder, _k=aot_topk):
                    from predictionio_tpu_torch.server.aot import AOTWarmup

                    return AOTWarmup(_ladder, ks=(_k,))
            self._mux = VariantSet(
                self.storage, variants, engine_factory=engine_factory,
                variant_id=variant_id, salt=variant_salt,
                warm_factory=warm_factory, device=self.device)
            self._scoreboard = VariantScoreboard()
            try:
                self._mux.load()
            except Exception as e:
                if require_engine:
                    raise
                self._load_error = f"{type(e).__name__}: {e}"
            default = self._mux.get(self._mux.default)
            if default.serving():
                # the default (champion) arm also serves every
                # single-model path: /, probes, the model generation
                self.deployed = default.deployed
                self._warmup = default.warmup
                self._mux.start_warmups()
            # the variant path is its own handler, so that a server
            # without variants runs none of it
            self._query_once = self._variant_query_once
        self._batcher = None
        if batching:
            from predictionio_tpu_torch.server.batching import MicroBatcher

            # the worker reads the serving engine at dispatch, so a
            # /reload swap reaches the batcher too; with variants it
            # takes the batch's arm as its group
            self._batcher = MicroBatcher(
                self._variant_batch_worker if variants else self._batch_worker,
                max_batch=batch_max, max_wait_ms=batch_wait_ms, ladder=ladder)
        router = Router()
        router.route("POST", "/queries.json", self._queries)
        router.route("POST", "/feedback.json", self._feedback_route)
        router.route("GET", "/variants", self._variants_route)
        router.route("POST", "/variants/weights", self._variants_weights)
        router.route("GET", "/", self._status)
        router.route("GET", "/health", self._health)
        router.route("GET", "/reload", self._reload)
        router.route("GET", "/stop", self._stop)
        router.route("GET", "/metrics", self._metrics)
        router.route("GET", "/metrics/history", self._metrics_history)
        router.route("GET", "/traces", traces_handler)
        router.route("GET", "/plugins.json", self._plugins_list)
        router.route("GET", "/plugins/{name}/{path+}", self._plugin_route)
        router.route("POST", "/plugins/{name}/{path+}", self._plugin_route)
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
                               server_name="engine")

    # -- workers ---------------------------------------------------------------

    def _deployed_for(self, variant: Optional[str]) -> DeployedEngine:
        """The engine behind one serving arm (the single deployed engine
        when multi-model serving is off). An arm that failed between its
        choice and its dispatch serves no one: its queries fail (500)
        rather than go quietly to another arm's factors."""
        if variant is None:
            return self.deployed
        rv = self._mux.get(variant)
        if rv.deployed is None:
            raise RuntimeError(f"variant {variant!r} is {rv.state}, not serving")
        return rv.deployed

    def _query_worker(self, query: Any, variant: Optional[str] = None) -> Any:
        # to_thread copies the contextvars context, so this span parents
        # to the request's engine.query span
        with tracing.span("engine.predict"):
            faults.inject("serving.query")
            return self._deployed_for(variant).query(query)

    def _batch_worker(self, queries: List[Any]) -> List[Any]:
        faults.inject("serving.query")
        return self.deployed.batch_query(queries)

    def _variant_batch_worker(self, queries: List[Any],
                              variant: Optional[str]) -> List[Any]:
        """One padded batch of ONE arm, scored through that arm's
        factors (the micro-batcher never mixes arms in a batch)."""
        faults.inject("serving.query")
        return self._deployed_for(variant).batch_query(queries)

    # -- handlers --------------------------------------------------------------

    def _retry_after_hint(self) -> float:
        """When a shed or not-ready 503 is worth retrying: the AOT
        warmup's remaining time while it warms, else the longest
        open-breaker reset window, else two in-flight query durations
        (shedding clears one slot per completion)."""
        if self._warmup is not None and self._warmup.state in (
                "idle", "warming"):
            eta = self._warmup.retry_after()
            if eta > 0:
                return eta
        open_waits = [b.retry_after() for b in self._breakers.values()
                      if b.state == OPEN]
        if open_waits:
            return max(open_waits)
        if self._lat_ewma > 0:
            return max(0.1, 2.0 * self._lat_ewma)
        return 1.0

    @staticmethod
    def _unavailable(message: str, retry_after: float = 1.0) -> Response:
        body = {"message": message,
                "retryAfterSec": round(max(0.0, retry_after), 3)}
        resp = Response.json(body, status=503)
        # integral seconds (RFC 9110 delta-seconds), ceil'd so that the
        # hint is never shorter than the real wait
        resp.headers["Retry-After"] = str(max(1, math.ceil(retry_after)))
        return resp

    async def _queries(self, req: Request) -> Response:
        t0 = time.perf_counter()
        # admission BEFORE any await: past the cap the server answers at
        # once instead of queueing work it cannot finish. Router canaries
        # (X-PIO-Probe) take no tenant's seat; with no cap no header is read.
        admit = bool(self.max_inflight) and "x-pio-probe" not in req.headers
        app = req.headers.get("x-pio-app", "") if admit else ""
        if admit and not self._fair.try_acquire(app):
            self._m_shed.inc((app or "-",))
            self._m_queries.inc(("503",))
            return self._unavailable(
                f"server overloaded ({self._inflight} queries in "
                f"flight; app {app or 'default'} at "
                f"{self._fair.inflight(app)}/{self._fair.share(app)} "
                "of its fair share)",
                retry_after=self._retry_after_hint())
        try:
            if self.deployed is None:
                self._m_queries.inc(("503",))
                return self._unavailable(
                    f"no engine loaded ({self._load_error}); "
                    "train and GET /reload",
                    retry_after=self._retry_after_hint())
            if self._warmup is not None and self._warmup.state in (
                    "idle", "warming"):
                status = "503"
                resp = self._unavailable(
                    "serving programs are still warming",
                    retry_after=self._warmup.retry_after())
            else:
                self._inflight += 1
                try:
                    async with tracing.span("engine.query") as sp:
                        # the attributes cost nothing while tracing is off
                        if sp is not tracing.NOOP_SPAN:
                            sp.attrs.update(
                                deadline_ms=self.query_timeout * 1e3,
                                inflight=self._inflight,
                                feedback_breaker=self._sink_breaker.state)
                        status, resp = await self._query_once(req)
                        sp.set_attr("status", status)
                        if status in ("500", "504"):
                            sp.set_error(f"query answered {status}")
                finally:
                    self._inflight -= 1
        finally:
            if admit:
                self._fair.release(app)
        self._m_queries.inc((status,))
        dt = time.perf_counter() - t0
        if status == "200":
            # loop-thread-only, like _inflight
            self._lat_ewma = dt if self._lat_ewma == 0 else (
                0.9 * self._lat_ewma + 0.1 * dt)
        # every outcome is observed: the 400/500/504 tails are the slow
        # failures worth seeing
        self._m_latency.observe(dt, (status,), exemplar=tracing.exemplar())
        return resp

    async def _query_once(self, req: Request) -> "tuple[str, Response]":
        try:
            query = req.json()
        except json.JSONDecodeError as e:
            return "400", Response.json(
                {"message": f"invalid JSON: {e}"}, status=400)
        if query is None:
            return "400", Response.json({"message": "empty query"}, status=400)
        return await self._dispatch_once(req, query, None)

    async def _variant_query_once(self, req: Request) -> "tuple[str, Response]":
        """``_query_once`` under multi-model serving (bound in its place
        at construction): choose the arm (``X-PIO-Variant`` overrides the
        split and must name a serving arm), dispatch to it, answer with
        the arm in ``X-PIO-Variant``, and score the request on its arm.
        Router canaries (``X-PIO-Probe``) are not scored."""
        from predictionio_tpu_torch.server.variants import (
            VariantError,
            entity_of,
        )

        t0 = time.perf_counter()
        try:
            query = req.json()
        except json.JSONDecodeError as e:
            return "400", Response.json(
                {"message": f"invalid JSON: {e}"}, status=400)
        if query is None:
            return "400", Response.json({"message": "empty query"}, status=400)
        try:
            variant = self._mux.choose(
                entity_of(query), req.headers.get("x-pio-variant") or None)
        except VariantError as e:
            return "400", Response.json({"message": str(e)}, status=400)
        status, resp = await self._dispatch_once(req, query, variant)
        # which arm answered (or would have): clients read the split here
        resp.headers["X-PIO-Variant"] = variant
        if "x-pio-probe" not in req.headers:
            self._scoreboard.observe_request(
                variant, time.perf_counter() - t0, status)
        return status, resp

    async def _dispatch_once(self, req: Request, query: Any,
                             variant: Optional[str]) -> "tuple[str, Response]":
        # a routing hop carries the client's remaining budget down in
        # X-PIO-Deadline-Ms; the deadline is the tighter of that and the
        # server's own query_timeout_ms (a garbage header is ignored)
        timeout = self.query_timeout
        hop = req.headers.get("x-pio-deadline-ms")
        if hop:
            try:
                hop_sec = float(hop) / 1e3
            except ValueError:
                hop_sec = 0.0
            if hop_sec > 0:
                timeout = min(timeout, hop_sec) if timeout > 0 else hop_sec
        try:
            if self._batcher is not None:
                work = self._batcher.submit(query, group=variant)
            else:
                work = asyncio.to_thread(self._query_worker, query, variant)
            if timeout > 0:
                prediction = await asyncio.wait_for(work, timeout)
            else:
                prediction = await work
        except asyncio.TimeoutError:
            # the worker thread may still be running; admission bounds
            # how many such stragglers can pile up
            self._m_deadline.inc()
            return "504", Response.json(
                {"message": "query deadline exceeded "
                            f"({timeout * 1e3:.0f} ms)"}, status=504)
        except (ValueError, KeyError, TypeError) as e:
            # malformed or invalid query (bad fields, unknown entity, wrong types)
            return "400", Response.json(
                {"message": f"query failed: {type(e).__name__}: {e}"},
                status=400)
        except Exception as e:
            # internal fault; retryable, so 500. Micro-batch failures are
            # isolated per query by the batcher, so a malformed query
            # still surfaces as its own ValueError → 400 above.
            return "500", Response.json(
                {"message": f"server error: {type(e).__name__}: {e}"},
                status=500)
        for p in self.plugins:
            prediction = p.output_blocker(query, prediction)
            p.output_sniffer(query, prediction)
        with self._counts_lock:
            self.query_count += 1
        self._last_good_query = query
        if self.feedback:
            pr_id = uuid.uuid4().hex
            if isinstance(prediction, dict):
                prediction = {**prediction, "prId": pr_id}
            if variant is not None:
                # remember what was served under this prId, so that
                # feedback is attributed and scored per arm
                self._scoreboard.record_served(pr_id, variant, prediction)
            self._submit_feedback(query, prediction, pr_id, variant)
        return "200", Response.json(prediction)

    def _submit_feedback(self, query: Any, prediction: Any,
                         pr_id: str, variant: Optional[str] = None) -> None:
        """Queue feedback for a DEDICATED two-thread executor: a slow or
        down Event Server (the HTTP sink blocks up to its timeout) must
        not eat the shared to_thread pool that query handling runs on.
        Bounded: past 256 in flight, feedback drops (counted), serving
        does not. A worker takes what has queued up (at most 50) and
        delivers it in one send, so feedback keeps pace with serving."""
        if self._feedback_pool is None:
            self._feedback_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="pio-feedback")
        # the request's context rides along only while tracing is on, so
        # that the feedback span joins the query's trace
        record = tid = None
        if tracing.TRACER.enabled:
            record = tracing.bind_current(self._record_feedback)
            tid = tracing.current_trace_id()
        with self._counts_lock:
            drop = self._feedback_inflight >= 256
            if not drop:
                self._feedback_inflight += 1
                self._feedback_queue.append(
                    (query, prediction, pr_id, variant, record, tid))
        if drop:
            self._m_feedback.inc(("dropped",))
            return
        self._feedback_pool.submit(self._drain_feedback)

    def _drain_feedback(self) -> None:
        """One executor task: send what is queued (at most 50), in the
        context of its first request when tracing is on."""
        with self._counts_lock:
            items = [self._feedback_queue.popleft() for _ in range(
                min(len(self._feedback_queue), self._FEEDBACK_BATCH))]
        if not items:
            return  # an earlier task took this one's event along
        try:
            record = items[0][4]
            if record is None:
                self._record_feedback(items)
            else:
                record(items, [it[5] for it in items if it[5]])
        finally:
            with self._counts_lock:
                self._feedback_inflight -= len(items)

    def _sink(self):
        if self._event_sink is None:
            # no Event Server configured: the in-process write against
            # the app named in the trained instance's data-source params
            from predictionio_tpu_torch.server.eventsink import DirectEventSink

            app_name = self.feedback_app_name
            if not app_name:
                dsp = json.loads(self.deployed.instance.data_source_params)
                app_name = dsp.get("app_name") or dsp.get("appName")
            if not app_name:
                return None
            self._event_sink = DirectEventSink(self.storage, app_name)
        return self._event_sink

    def _record_feedback(self, items: List[tuple],
                         links: Optional[List[str]] = None) -> None:
        """Feedback loop: served predictions become ``predict`` events
        tagged with their prId, delivered through the configured sink
        (the Event Server's authenticated HTTP API when a feedback URL is
        set, reference: CreateServer feedback, SURVEY.md §3.2; else a
        direct local write) inside the sink breaker, one breaker call a
        send: repeated failures trip it open and later feedback drops
        fast (counted as ``breaker_open``) until the sink recovers. With
        variants each event carries its SERVING ARM, so consumers can
        score arms without the prId map. Counted per event."""
        n = len(items)
        with tracing.span("engine.feedback", pr_id=items[0][2], records=n,
                          link_traces=links or []) as sp:
            try:
                sink = self._sink()
                if sink is None:
                    sp.set_attr("result", "no_sink")
                    return
                events = []
                for query, prediction, pr_id, variant, *_ in items:
                    props = {"query": query, "prediction": prediction}
                    if variant is not None:
                        props["variant"] = variant
                    events.append(Event(
                        event="predict", entity_type="pio_pr",
                        entity_id=pr_id, properties=props, pr_id=pr_id))
                send = getattr(sink, "send_batch", None)
                if send is None:  # a sink with send() alone
                    self._send_each(sink, events, sp)
                    return
                try:
                    ids = self._sink_breaker.call(send, events)
                except CircuitOpenError:
                    raise
                except Exception:
                    # one failed send is n failed deliveries: the breaker
                    # counts each, as it counts the JAX package's one
                    # event a call (the call itself recorded one)
                    for _ in range(n - 1):
                        self._sink_breaker.record_failure()
                    raise
                ok = sum(i is not None for i in ids)
                if ok:
                    self._m_feedback.inc(("ok",), n=ok)
                if ok < n:
                    self._m_feedback.inc(("error",), n=n - ok)
                    sp.set_error(f"{n - ok} of {n} events refused")
                else:
                    sp.set_attr("result", "ok")
            except CircuitOpenError:
                self._m_feedback.inc(("breaker_open",), n=n)
                sp.set_error("feedback sink breaker open")
            except Exception as e:
                self._m_feedback.inc(("error",), n=n)  # never breaks serving
                sp.set_error(f"{type(e).__name__}: {e}")

    def _send_each(self, sink, events: List[Event], sp) -> None:
        """A sink with ``send()`` alone: each event is one breaker call,
        counted on its own (ok, error, or breaker_open once the breaker
        has opened), as the JAX package sends and counts each event; a
        failed event does not drop the rest of the backlog."""
        counts = {"ok": 0, "error": 0, "breaker_open": 0}
        for e in events:
            try:
                ok = self._sink_breaker.call(sink.send, e) is not None
                counts["ok" if ok else "error"] += 1
            except CircuitOpenError:
                counts["breaker_open"] += 1
            except Exception:
                counts["error"] += 1
        for status, k in counts.items():
            if k:
                self._m_feedback.inc((status,), n=k)
        if counts["ok"] == len(events):
            sp.set_attr("result", "ok")
        else:
            sp.set_error(f"{len(events) - counts['ok']} of {len(events)} "
                         "events not delivered")

    # -- variant surface -------------------------------------------------------

    async def _feedback_route(self, req: Request) -> Response:
        """POST /feedback.json: close the online loop for one served
        prediction, ``{"prId": ..., "rating": 4.0, "item": ...}`` or
        ``{"prId": ..., "click": true}`` (an explicit ``"variant"``
        attributes directly when the prId is unknown or evicted). Accrues
        into the per-variant online series."""
        if self._scoreboard is None:
            return Response.json(
                {"message": "variant serving not enabled "
                            "(deploy with --variants)"}, status=404)
        try:
            body = req.json()
        except json.JSONDecodeError as e:
            return Response.json(
                {"message": f"invalid JSON: {e}"}, status=400)
        if not isinstance(body, dict):
            return Response.json(
                {"message": "feedback body must be a JSON object"},
                status=400)
        rating = body.get("rating")
        if rating is not None:
            try:
                rating = float(rating)
            except (TypeError, ValueError):
                return Response.json(
                    {"message": f"bad rating {body.get('rating')!r}"},
                    status=400)
        clicked = body.get("click", body.get("clicked"))
        variant = self._scoreboard.observe_feedback(
            pr_id=body.get("prId"),
            variant=body.get("variant"),
            rating=rating,
            item=body.get("item"),
            clicked=bool(clicked) if clicked is not None else None)
        if variant is None:
            return Response.json(
                {"message": "feedback not attributable: unknown prId "
                            "and no variant given"}, status=404)
        return Response.json({"accepted": True, "variant": variant})

    async def _variants_route(self, req: Request) -> Response:
        """GET /variants: the resident variant set, with per-arm
        generation, warm-up state, weights and accrued online stats."""
        if self._mux is None:
            return Response.json(
                {"message": "variant serving not enabled"}, status=404)
        snap = self._mux.snapshot()
        stats = self._scoreboard.snapshot()
        for name, v in snap["variants"].items():
            v["online"] = stats.get(name)
        return Response.json(snap)

    async def _variants_weights(self, req: Request) -> Response:
        """POST /variants/weights: probe-then-apply split edit,
        ``{"weights": {"champion": 9, "challenger": 1}}``. Every named arm
        must be resident AND serving or NOTHING changes (409)."""
        if self._mux is None:
            return Response.json(
                {"message": "variant serving not enabled"}, status=404)
        from predictionio_tpu_torch.server.variants import VariantError

        try:
            body = req.json()
        except json.JSONDecodeError as e:
            return Response.json(
                {"message": f"invalid JSON: {e}"}, status=400)
        weights = body.get("weights") if isinstance(body, dict) else None
        if not isinstance(weights, dict):
            return Response.json(
                {"message": 'body must be {"weights": {name: weight}}'},
                status=400)
        try:
            eff = self._mux.set_weights(weights)
        except VariantError as e:
            return Response.json({"message": str(e)}, status=409)
        return Response.json({
            "applied": True,
            "effectiveWeights": dict(eff),
            "weightsEpoch": self._mux.weights_epoch,
        })

    async def _status(self, req: Request) -> Response:
        if self.deployed is None:
            return Response.json({
                "status": "not-ready",
                "message": self._load_error,
                "startTime": self.start_time.isoformat(timespec="milliseconds"),
                "queryCount": self.query_count,
            })
        ei = self.deployed.instance
        body = {
            "status": "alive",
            "engineFactory": ei.engine_factory,
            "engineInstanceId": ei.id,
            "engineVariant": ei.engine_variant,
            "startTime": self.start_time.isoformat(timespec="milliseconds"),
            "queryCount": self.query_count,
            "algorithms": [name for name, _ in self.deployed.algorithms],
        }
        if self._warmup is not None:
            body["warmup"] = self._warmup.progress()
        return Response.json(body)

    def _health_doc(self) -> Dict[str, Any]:
        """Sync health and variants snapshot for incident bundles: the
        /health body's facts without going through the event loop."""
        doc: Dict[str, Any] = {
            "breakers": {n: b.state for n, b in self._breakers.items()},
            "inflight": self._inflight,
            "reloadGeneration": self.reload_generation,
            "lastSwap": self.last_swap,
            "instance": self.instance_uid,
            "startedAt": round(self.start_epoch, 3),
            "loaded": self.deployed is not None,
        }
        if self._warmup is not None:
            doc["warmup"] = self._warmup.progress()
        if self._mux is not None:
            doc["variants"] = self._mux.snapshot()
        return doc

    async def _health(self, req: Request) -> Response:
        """Liveness and readiness for supervisors and load balancers.

        - ``200 {"status": "ok"}``: serving, every breaker closed;
        - ``200 {"status": "degraded"}``: serving, but a breaker is open,
          the server is at its inflight cap, or the AOT warmup failed. A
          supervisor must not restart on this, so it stays below 500;
        - ``503 {"status": "not-ready"}``: no engine loaded yet, or the
          bucket ladder is still warming (the ``warmup`` block carries
          progress).

        With variants, ``variants`` carries the resident set; any arm
        still warming keeps the server not-ready, and a failed arm makes
        it degraded, named in ``reason``.
        """
        open_breakers = [n for n, b in self._breakers.items()
                         if b.state == OPEN]
        at_capacity = bool(self.max_inflight
                           and self._inflight >= self.max_inflight)
        body = {
            "breakers": {n: b.state for n, b in self._breakers.items()},
            "inflight": self._inflight,
            "inflightByApp": self._fair.snapshot(),
            "reloadGeneration": self.reload_generation,
            "modelGeneration": self._model_generation(),
            "lastSwap": self.last_swap,
            "instance": self.instance_uid,
            "startedAt": round(self.start_epoch, 3),
        }
        if self._warmup is not None:
            body["warmup"] = self._warmup.progress()
        if self._mux is not None:
            body["variants"] = self._mux.snapshot()
        if self.deployed is None:
            return self._not_ready(self._load_error or "no engine loaded",
                                   body)
        if self._warmup is not None and self._warmup.state in (
                "idle", "warming"):
            return self._not_ready("aot warmup in progress", body)
        mux_warm = (self._mux.warm_state() if self._mux is not None
                    else "ready")
        if mux_warm == "warming":
            return self._not_ready("variant aot warmup in progress", body)
        failed_arms = ([n for n, v in body["variants"]["variants"].items()
                        if v["state"] == "failed"]
                       if self._mux is not None else [])
        warmup_failed = (self._warmup is not None
                         and self._warmup.state == "failed")
        if (open_breakers or at_capacity or warmup_failed
                or mux_warm == "failed" or failed_arms):
            reason = ("breaker open: " + ",".join(open_breakers)
                      if open_breakers else
                      "at inflight capacity" if at_capacity else
                      "aot warmup failed" if warmup_failed else
                      "variant aot warmup failed" if mux_warm == "failed"
                      else "variant failed: " + ",".join(failed_arms))
            return Response.json(
                {"status": "degraded", "reason": reason, **body})
        return Response.json({"status": "ok", **body})

    def _model_generation(self) -> Optional[int]:
        """Registry generation of the serving instance, or None when no
        engine is loaded, the instance was never registered, or there is
        no registry at this storage home."""
        if self.deployed is None:
            return None
        try:
            return find_gen(self.storage.config.home,
                            self.deployed.instance.id)
        except Exception:
            return None

    def _record_swap(self, outcome: str, **extra: Any) -> Dict[str, Any]:
        """Remember a /reload outcome for /health's ``lastSwap``:
        ``promoted`` (swap landed), ``rolled_back`` (candidate failed its
        warm-up or probe, old engine kept), ``refused`` (candidate never
        loaded)."""
        self.last_swap = {"outcome": outcome,
                          "at": round(time.time(), 3), **extra}
        return self.last_swap

    def _not_ready(self, reason: str, body: Dict[str, Any]) -> Response:
        hint = self._retry_after_hint()
        resp = Response.json(
            {"status": "not-ready", "reason": reason,
             "retryAfterSec": round(hint, 3), **body},
            status=503)
        resp.headers["Retry-After"] = str(max(1, math.ceil(hint)))
        return resp

    def _probe_worker(self, candidate: DeployedEngine, probe: Any) -> None:
        faults.inject("serving.reload")
        candidate.query(probe)

    def _rolled_back(self, sp: Any, reason: str, e: Exception) -> Response:
        self._m_reloads.inc(("rolled_back",))
        sp.set_error(f"{reason}; rolled back")
        kept = self.deployed.instance.id if self.deployed is not None else None
        self._record_swap("rolled_back", reason=reason, engineInstanceId=kept)
        return Response.json(
            {"message": f"reload rolled back: {reason}: "
                        f"{type(e).__name__}: {e}",
             "engineInstanceId": kept, "swap": "rolled_back"},
            status=500)

    async def _reload(self, req: Request) -> Response:
        """Hot-swap to the latest COMPLETED instance (reference: /reload).

        Reloads are serialized; the last-good engine keeps serving
        throughout. The candidate is loaded on the server's own device,
        its bucket ladder warmed (a same-geometry candidate only adopts
        the cached programs), and it must answer the last successfully
        served query before the swap, so that a candidate which loads
        but cannot serve never becomes live.
        """
        if self._reload_lock is None:
            self._reload_lock = asyncio.Lock()
        async with tracing.span("engine.reload",
                                generation=self.reload_generation) as sp, \
                self._reload_lock:
            if self._mux is not None:
                return await self._reload_variant_locked(req, sp)
            factory = self.engine_factory or (
                self.deployed.instance.engine_factory
                if self.deployed is not None else None)
            if factory is None:
                self._m_reloads.inc(("failed",))
                sp.set_error("no engine factory known")
                return Response.json(
                    {"message": "reload failed: no engine factory known"},
                    status=500)
            try:
                new = await asyncio.to_thread(
                    prepare_deploy, factory, None, self.storage,
                    self.variant_id, self.device)
            except Exception as e:
                self._m_reloads.inc(("failed",))
                sp.set_error(f"reload failed: {e}")
                self._record_swap("refused", reason=f"{type(e).__name__}: {e}")
                return Response.json(
                    {"message": f"reload failed: {e}", "swap": "refused"},
                    status=500)
            if self._warmup is not None:
                # warm the CANDIDATE's ladder before the probe and the
                # swap, off the hot path, while the old engine serves
                try:
                    await asyncio.to_thread(self._warmup.warm_sync, new)
                    self._warmup.mark_ready()
                except Exception as e:
                    return self._rolled_back(sp, "aot warmup failed", e)
            probe = self._last_good_query
            if self.reload_probe and probe is not None:
                try:
                    work = asyncio.to_thread(self._probe_worker, new, probe)
                    if self.query_timeout > 0:
                        await asyncio.wait_for(work, self.query_timeout)
                    else:
                        await work
                except Exception as e:
                    return self._rolled_back(sp, "probe query failed", e)
            self.deployed = new
            self.reload_generation += 1
            self._m_reload_gen.set(self.reload_generation)
            self._m_reloads.inc(("ok",))
            sp.set_attr("result", "ok")
            self._load_error = None
            generation = self._model_generation()
            self._record_swap("promoted", engineInstanceId=new.instance.id,
                              modelGeneration=generation)
            return Response.json({"message": "Reloaded",
                                  "engineInstanceId": new.instance.id,
                                  "reloadGeneration": self.reload_generation,
                                  "modelGeneration": generation,
                                  "swap": "promoted"})

    async def _reload_variant_locked(self, req: Request, sp: Any) -> Response:
        """``/reload[?variant=name]`` under multi-model serving: swap ONE
        arm onto its freshly resolved registry generation, on the
        server's device, leaving every other arm resident and serving.
        Defaults to the champion arm. Outcomes mirror the single-model
        reload: ``promoted``, ``rolled_back`` (the default arm keeps its
        last-good engine), ``failed`` (a non-default arm drops out of the
        split; the champion absorbs its weight until the next good swap)."""
        from predictionio_tpu_torch.server.variants import VariantError

        target = req.param("variant") or self._mux.default
        probe_fn = None
        if self.reload_probe and self._last_good_query is not None:
            last = self._last_good_query

            def probe_fn(candidate: Any, _q: Any = last) -> None:
                self._probe_worker(candidate, _q)

        try:
            out = await asyncio.to_thread(
                self._mux.reload_variant, target, probe_fn)
        except VariantError as e:
            self._m_reloads.inc(("failed",))
            sp.set_error(str(e))
            return Response.json({"message": str(e)}, status=404)
        if out["outcome"] == "promoted":
            rv = self._mux.get(target)
            if target == self._mux.default:
                self.deployed = rv.deployed
                self._warmup = rv.warmup or self._warmup
                self._load_error = None
            self.reload_generation += 1
            self._m_reload_gen.set(self.reload_generation)
            self._m_reloads.inc(("ok",))
            sp.set_attr("result", "ok")
            self._record_swap(
                "promoted", variant=target,
                engineInstanceId=out.get("engineInstanceId"),
                modelGeneration=out.get("generation"))
            return Response.json({
                "message": "Reloaded", "variant": target,
                "engineInstanceId": out.get("engineInstanceId"),
                "modelGeneration": out.get("generation"),
                "reloadGeneration": self.reload_generation,
                "swap": "promoted"})
        result = out["outcome"]  # rolled_back | failed
        self._m_reloads.inc((result,))
        sp.set_error(f"variant reload {result}: {out.get('error')}")
        self._record_swap(result, variant=target, reason=out.get("error"))
        return Response.json(
            {"message": f"reload {result}: {out.get('error')}",
             "variant": target, "swap": result},
            status=500)

    async def _stop(self, req: Request) -> Response:
        asyncio.get_running_loop().call_later(0.05, self.http.request_shutdown)
        return Response.json({"message": "Shutting down"})

    async def _metrics(self, req: Request) -> Response:
        return Response.text(REGISTRY.render(),
                             content_type="text/plain; version=0.0.4")

    async def _metrics_history(self, req: Request) -> Response:
        status, payload = history_payload(
            self.tsdb, req.param("series") or "", req.param("window") or "")
        return Response.json(payload, status=status)

    async def _plugins_list(self, req: Request) -> Response:
        return Response.json({"plugins": {
            "outputblockers": [p.name for p in self.plugins],
            "outputsniffers": [p.name for p in self.plugins],
        }})

    async def _plugin_route(self, req: Request) -> Response:
        name = req.path_params["name"]
        for p in self.plugins:
            if p.name == name:
                body = req.json() if req.body else None
                out = p.handle_route(req.path_params["path"], body)
                return Response.json(out)
        return Response.json({"message": f"no plugin {name!r}"}, status=404)

    # -- lifecycle -------------------------------------------------------------

    async def serve_forever(self) -> None:
        if self.incidents is not None:
            from predictionio_tpu_torch.utils.incidents import (
                install_crash_handlers,
            )

            install_crash_handlers(self.incidents)
        scraper = asyncio.create_task(
            scrape_loop(self.tsdb, self.scrape_interval),
            name="pio-engine-tsdb")
        try:
            await self.http.serve_forever()
        finally:
            scraper.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await scraper
            # the batcher's collector task must die BEFORE the loop
            # closes, or its pending queue.get() touches a closed loop
            if self._batcher is not None:
                self._batcher.stop()

    def run(self) -> None:
        asyncio.run(self.serve_forever())
