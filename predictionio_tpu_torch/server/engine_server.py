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

Left out of the port for now (ROADMAP.md queue 1, item 4): feedback and
its ``/feedback.json`` route (the ``feedback_sink`` breaker exists and
``/health`` reports it, but nothing trips it yet), plugins, multi-model
variants (``/variants``, ``X-PIO-Variant``) and incident capture.
"""

from __future__ import annotations

import asyncio
import contextlib
import datetime as _dt
import json
import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.core.workflow import DeployedEngine, prepare_deploy
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
from predictionio_tpu_torch.utils.resilience import OPEN, CircuitBreaker
from predictionio_tpu_torch.utils.timeseries import (
    TimeSeriesStore,
    history_payload,
    scaled_tiers,
    scrape_loop,
)


class EngineServer:
    def __init__(
        self,
        engine_factory: Optional[str] = None,
        instance_id: Optional[str] = None,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = 8000,
        variant_id: str = "",
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
        tenant_quotas: Optional[Any] = None,
        scrape_interval: float = 10.0,
        device=None,
    ) -> None:
        # resolved first: with no card and no CPU request the server
        # raises even when require_engine=False would let it come up
        self.device = resolve_device(device)
        self.storage = storage or get_storage()
        self.engine_factory = engine_factory
        self.variant_id = variant_id
        self.deployed: Optional[DeployedEngine] = None
        self._load_error: Optional[str] = None
        try:
            self.deployed = prepare_deploy(
                engine_factory=engine_factory, instance_id=instance_id,
                storage=self.storage, variant_id=variant_id,
                device=self.device)
        except Exception as e:
            # with require_engine=False the server still comes up (and
            # reports not-ready), so that ops can deploy before the first
            # train and /reload the model in later
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
        #: the feedback sink's breaker: closed until feedback is ported,
        #: reported on /health under the JAX server's name
        self._sink_breaker = CircuitBreaker(
            "engine_feedback_sink", failure_threshold=5, reset_timeout=10.0)
        self._breakers: Dict[str, CircuitBreaker] = {
            "feedback_sink": self._sink_breaker}
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
            self._warmup = AOTWarmup(ladder, ks=(aot_topk,))
            if self.deployed is not None:
                self._warmup.start(self.deployed)
        self._batcher = None
        if batching:
            from predictionio_tpu_torch.server.batching import MicroBatcher

            # the worker reads self.deployed at dispatch, so a /reload
            # swap reaches the batcher too
            self._batcher = MicroBatcher(
                self._batch_worker, max_batch=batch_max,
                max_wait_ms=batch_wait_ms, ladder=ladder)
        router = Router()
        router.route("POST", "/queries.json", self._queries)
        router.route("GET", "/", self._status)
        router.route("GET", "/health", self._health)
        router.route("GET", "/reload", self._reload)
        router.route("GET", "/stop", self._stop)
        router.route("GET", "/metrics", self._metrics)
        router.route("GET", "/metrics/history", self._metrics_history)
        router.route("GET", "/traces", traces_handler)
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

    def _query_worker(self, query: Any) -> Any:
        # to_thread copies the contextvars context, so this span parents
        # to the request's engine.query span
        with tracing.span("engine.predict"):
            faults.inject("serving.query")
            return self.deployed.query(query)

    def _batch_worker(self, queries: List[Any]) -> List[Any]:
        faults.inject("serving.query")
        return self.deployed.batch_query(queries)

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
                work = self._batcher.submit(query)
            else:
                work = asyncio.to_thread(self._query_worker, query)
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
        with self._counts_lock:
            self.query_count += 1
        self._last_good_query = query
        return "200", Response.json(prediction)

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

    async def _health(self, req: Request) -> Response:
        """Liveness and readiness for supervisors and load balancers.

        - ``200 {"status": "ok"}``: serving, every breaker closed;
        - ``200 {"status": "degraded"}``: serving, but a breaker is open,
          the server is at its inflight cap, or the AOT warmup failed. A
          supervisor must not restart on this, so it stays below 500;
        - ``503 {"status": "not-ready"}``: no engine loaded yet, or the
          bucket ladder is still warming (the ``warmup`` block carries
          progress).
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
        if self.deployed is None:
            return self._not_ready(self._load_error or "no engine loaded",
                                   body)
        if self._warmup is not None and self._warmup.state in (
                "idle", "warming"):
            return self._not_ready("aot warmup in progress", body)
        warmup_failed = (self._warmup is not None
                         and self._warmup.state == "failed")
        if open_breakers or at_capacity or warmup_failed:
            reason = ("breaker open: " + ",".join(open_breakers)
                      if open_breakers else
                      "at inflight capacity" if at_capacity else
                      "aot warmup failed")
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

    # -- lifecycle -------------------------------------------------------------

    async def serve_forever(self) -> None:
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
