"""Engine Server: query serving on :8000, on the card.

Reference: [U] core/.../workflow/CreateServer.scala (SURVEY.md §3.2),
and the query path of the JAX package's ``server/engine_server.py``.
Routes:

- ``POST /queries.json`` → prediction JSON (the p50-critical path)
- ``GET  /``             → engine status JSON
- ``GET  /stop``         → shut the server down

The model stays resident on the serving device; prediction runs on a
worker thread (or, with ``batching``, on the micro-batcher's dispatch
thread) so the asyncio loop never blocks on the device. Errors answer
JSON: 400 for a malformed query, 500 for a server fault, and 503 with
``Retry-After`` while the AOT warmup has not finished warming the
serving programs (on the card that includes building the kernel).
Feedback, plugins, variants, tenancy quotas, the reload probe and the
metrics history of the JAX server are later slices of the port
(ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import json
import math
import threading
import time
from typing import Any, List, Optional

from predictionio_tpu_torch.core.workflow import DeployedEngine, prepare_deploy
from predictionio_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
)
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils import tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY


class EngineServer:
    def __init__(
        self,
        engine_factory: Optional[str] = None,
        instance_id: Optional[str] = None,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = 8000,
        variant_id: str = "",
        batching: bool = False,
        batch_max: int = 64,
        batch_wait_ms: float = 0.0,
        aot_buckets: Optional[str] = None,
        aot_topk: int = 16,
        device=None,
    ) -> None:
        self.storage = storage or get_storage()
        self.deployed: DeployedEngine = prepare_deploy(
            engine_factory=engine_factory, instance_id=instance_id,
            storage=self.storage, variant_id=variant_id, device=device)
        self.start_time = _dt.datetime.now(_dt.timezone.utc)
        self.query_count = 0
        self._count_lock = threading.Lock()
        self._m_queries = REGISTRY.counter(
            "pio_engine_queries_total", "Queries served", ("status",))
        self._m_latency = REGISTRY.histogram(
            "pio_engine_query_seconds", "Query latency (handler, seconds)",
            labelnames=("status",))
        #: AOT warmup: warm the serving program for every padded batch
        #: bucket at deploy time, so no query shape ≤ max_batch meets a
        #: cold program on the hot path
        self._warmup = None
        ladder = None
        if aot_buckets is not None:
            from predictionio_tpu_torch.server.aot import AOTWarmup, BucketLadder

            ladder = BucketLadder.parse(aot_buckets, batch_max)
            # an explicit ladder defines its own max batch: collecting
            # past the top bucket would dispatch an unwarmed shape
            batch_max = ladder.max_batch
            self._warmup = AOTWarmup(ladder, ks=(aot_topk,))
            self._warmup.start(self.deployed)
        self._batcher = None
        if batching:
            from predictionio_tpu_torch.server.batching import MicroBatcher

            self._batcher = MicroBatcher(
                self._batch_worker, max_batch=batch_max,
                max_wait_ms=batch_wait_ms, ladder=ladder)
        router = Router()
        router.route("POST", "/queries.json", self._queries)
        router.route("GET", "/", self._status)
        router.route("GET", "/stop", self._stop)
        # retry a busy port for a few seconds, while a previous server on
        # it shuts down
        self.http = HTTPServer(router, host, port, bind_retries=3,
                               server_name="engine")

    # -- workers ---------------------------------------------------------------

    def _query_worker(self, query: Any) -> Any:
        # to_thread copies the contextvars context, so this span parents
        # to the request's engine.query span
        with tracing.span("engine.predict"):
            return self.deployed.query(query)

    def _batch_worker(self, queries: List[Any]) -> List[Any]:
        return self.deployed.batch_query(queries)

    # -- handlers --------------------------------------------------------------

    async def _queries(self, req: Request) -> Response:
        t0 = time.perf_counter()
        if self._warmup is not None and self._warmup.state in ("idle", "warming"):
            hint = self._warmup.retry_after()
            status = "503"
            resp = Response.json(
                {"message": "serving programs are still warming",
                 "retryAfterSec": round(hint, 3)}, status=503)
            resp.headers["Retry-After"] = str(max(1, math.ceil(hint)))
        else:
            async with tracing.span("engine.query") as sp:
                status, resp = await self._query_once(req)
                sp.set_attr("status", status)
                if status == "500":
                    sp.set_error("query answered 500")
        self._m_queries.inc((status,))
        self._m_latency.observe(time.perf_counter() - t0, (status,),
                                exemplar=tracing.exemplar())
        return resp

    async def _query_once(self, req: Request) -> "tuple[str, Response]":
        try:
            query = req.json()
        except json.JSONDecodeError as e:
            return "400", Response.json(
                {"message": f"invalid JSON: {e}"}, status=400)
        if query is None:
            return "400", Response.json({"message": "empty query"}, status=400)
        try:
            if self._batcher is not None:
                prediction = await self._batcher.submit(query)
            else:
                prediction = await asyncio.to_thread(self._query_worker, query)
        except (ValueError, KeyError, TypeError) as e:
            # malformed/invalid query (bad fields, unknown entity, wrong types)
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
        with self._count_lock:
            self.query_count += 1
        return "200", Response.json(prediction)

    async def _status(self, req: Request) -> Response:
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

    async def _stop(self, req: Request) -> Response:
        asyncio.get_running_loop().call_later(0.05, self.http.request_shutdown)
        return Response.json({"message": "Shutting down"})

    # -- lifecycle -------------------------------------------------------------

    async def serve_forever(self) -> None:
        try:
            await self.http.serve_forever()
        finally:
            # the batcher's collector task must die BEFORE the loop
            # closes, or its pending queue.get() touches a closed loop
            if self._batcher is not None:
                self._batcher.stop()

    def run(self) -> None:
        asyncio.run(self.serve_forever())
