"""The port's fleet router held against the JAX package's, on the CPU.

Every case of ``tests/test_router.py`` runs on both packages against stub
replicas built on each package's own HTTP server: the replica state
machine, P2C routing, the retry budget, hedging, Retry-After, deadline
and trace propagation, identity resets, manifest watching and the
rolling reload. The cases drive the router's own ticks
(``_poll_all``, ``_push_variant_pins``) on its loop instead of sleeping
through health intervals, and wait only through a bounded
``wait_until``. The passive-ejection case forces traffic onto the dark
replica by seeding the live one's EWMA higher, so that P2C must pick the
dark one until its breaker opens. Then ``TestRouterVariantPins`` of
``tests/test_variants.py`` on both packages, and the port's own checks:
two port engine servers (``device="cpu"``) behind the port router and
two JAX engine servers behind the JAX router on one JAX-trained home give
the same answers and the same ``/top`` and ``/slo/status`` keys, series
and replica fields; a router with no replica answers 503; and the
continuous trainer's ``router_url`` and ``fleet_manifest`` pushes reach
a live port router's replicas.

Counters are process-global and each package has its own registry, so
the cases compare deltas of each package's counters (``cval``).
"""

import asyncio
import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.server import http as jax_http
from predictionio_tpu.server import router as jax_router
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu_torch.server import http as port_http
from predictionio_tpu_torch.server import router as port_router
from predictionio_tpu_torch.server import trainer as port_trainer
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.utils import faults as port_faults
from tests.test_servers import ServerThread, free_port, http
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

PKG = {
    "jax": SimpleNamespace(name="jax", http=jax_http, router=jax_router,
                           faults=jax_faults.FAULTS),
    "port": SimpleNamespace(name="port", http=port_http, router=port_router,
                            faults=port_faults.FAULTS),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def disarm_faults():
    for p in PKG.values():
        p.faults.disarm()
    yield
    for p in PKG.values():
        p.faults.disarm()


def http_full(method, url, body=None, headers=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode() or "null"), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null"), dict(e.headers)


def http_text(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def cval(counter, *labels):
    """Current value of one labelled counter series (counters are
    process-global: a case asserts deltas around its action)."""
    return counter._values.get(tuple(labels), 0)


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def on_loop(thread, coro, timeout=30.0):
    """Run ``coro`` on a ServerThread's loop (the router's own) and wait."""
    return asyncio.run_coroutine_threadsafe(coro, thread.loop).result(timeout)


class StubReplica:
    """A scriptable engine-server stand-in on one package's HTTP server,
    speaking the replica contract the router depends on: /health with
    identity fields, /queries.json, /events.json (non-idempotent),
    /reload and /metrics."""

    def __init__(self, pkg, port, instance="stub", latency=0.0):
        self.port = port
        self.instance = instance
        self.health_status = "ok"
        self.health_retry_after = None
        self.latency = latency
        self.query_status = 200
        self.query_retry_after = None
        self.fail_first = 0
        self.started_at = 1000.0
        self.reload_generation = 0
        self.reload_status = 200
        self.queries = 0
        self.events = 0
        self.reloads = 0
        self.metrics_text = 'pio_engine_queries_total{status="200"} 5\n'
        self._Response = pkg.http.Response
        router = pkg.http.Router()
        router.route("GET", "/", self._root)
        router.route("GET", "/health", self._health)
        router.route("GET", "/reload", self._reload)
        router.route("GET", "/metrics", self._metrics)
        router.route("POST", "/queries.json", self._query)
        router.route("POST", "/events.json", self._event)
        self.http = pkg.http.HTTPServer(router, "127.0.0.1", port,
                                        access_log=False, server_name="stub")

    @property
    def url(self):
        return f"127.0.0.1:{self.port}"

    async def serve_forever(self):
        await self.http.serve_forever()

    async def _root(self, req):
        return self._Response.json({"status": "stub"})

    async def _metrics(self, req):
        return self._Response.text(self.metrics_text)

    async def _health(self, req):
        body = {"status": self.health_status, "instance": self.instance,
                "startedAt": self.started_at,
                "reloadGeneration": self.reload_generation}
        if self.health_status == "not-ready":
            if self.health_retry_after is not None:
                body["retryAfterSec"] = self.health_retry_after
            resp = self._Response.json(body, status=503)
            resp.headers["Retry-After"] = "1"
            return resp
        return self._Response.json(body)

    async def _query(self, req):
        self.queries += 1
        if self.latency:
            await asyncio.sleep(self.latency)
        if self.fail_first > 0:
            self.fail_first -= 1
            return self._Response.json({"message": "induced failure"}, status=500)
        if self.query_status != 200:
            resp = self._Response.json({"message": "induced"},
                                       status=self.query_status)
            if self.query_retry_after is not None:
                resp.headers["Retry-After"] = self.query_retry_after
            return resp
        return self._Response.json({"instance": self.instance,
                                    "seen": dict(req.headers)})

    async def _event(self, req):
        self.events += 1
        if self.query_status != 200:
            return self._Response.json({"message": "induced"},
                                       status=self.query_status)
        return self._Response.json({"eventId": "stub"}, status=201)

    async def _reload(self, req):
        if self.reload_status != 200:
            return self._Response.json({"message": "induced"},
                                       status=self.reload_status)
        self.reloads += 1
        self.reload_generation += 1
        return self._Response.json({"reloadGeneration": self.reload_generation})


@contextlib.contextmanager
def fleet(pkg, n=2, router_kwargs=None, stub_latency=None):
    """n stub replicas of package ``pkg`` and that package's router over
    them, each on its own thread. Yields (router, stubs, stub threads,
    router thread)."""
    p = PKG[pkg]
    stubs = [StubReplica(p, free_port(), instance=f"stub-{i}",
                         latency=(stub_latency or [0.0] * n)[i])
             for i in range(n)]
    with contextlib.ExitStack() as stack:
        threads = [stack.enter_context(ServerThread(s)) for s in stubs]
        router = p.router.FleetRouter([s.url for s in stubs],
                                      host="127.0.0.1", port=free_port(),
                                      **(router_kwargs or {}))
        rt = stack.enter_context(ServerThread(router))
        yield router, stubs, threads, rt


def replica_of(router, stub):
    return next(r for r in router.replicas if r.name == stub.url)


# -- replica units --------------------------------------------------------------


@BOTH
def test_parse_hostport_accepts_bare_and_url_forms(pkg):
    Replica = PKG[pkg].router.Replica
    assert Replica.parse_hostport("10.0.0.1:8000") == ("10.0.0.1", 8000)
    assert Replica.parse_hostport("http://h:81") == ("h", 81)
    with pytest.raises(ValueError, match="host:port"):
        Replica.parse_hostport("no-port-here")


@BOTH
def test_availability_gates(pkg):
    mod = PKG[pkg].router
    r = mod.Replica(f"127.0.0.1:{free_port()}")
    r.state = mod.OK
    assert r.available(now=0.0)
    r.draining = True
    assert not r.available(now=0.0)
    r.draining = False
    r.backoff_until = 10.0
    assert not r.available(now=0.0)
    assert r.available(now=10.0)
    r.state = mod.DOWN
    assert not r.available(now=10.0)


@BOTH
def test_attempt_retryable_classification(pkg):
    mod = PKG[pkg].router
    r = mod.Replica(f"127.0.0.1:{free_port()}")
    assert mod._Attempt(r, 0, {}, b"").retryable
    assert mod._Attempt(r, 500, {}, b"").retryable
    assert mod._Attempt(r, 429, {}, b"").retryable
    assert not mod._Attempt(r, 200, {}, b"").retryable
    assert not mod._Attempt(r, 404, {}, b"").retryable


@BOTH
def test_score_and_ewma(pkg):
    r = PKG[pkg].router.Replica(f"127.0.0.1:{free_port()}")
    assert r.score() == pytest.approx(1e-4)      # a fresh replica competes
    r.observe(0.010)
    assert r.ewma_sec == pytest.approx(0.010)
    r.observe(0.020)
    assert r.ewma_sec == pytest.approx(0.012)
    r.inflight = 2
    assert r.score() == pytest.approx(3 * 0.012)
    r.reset_runtime()
    assert r.ewma_sec == 0.0 and r.breaker.state == "closed"


# -- routing ----------------------------------------------------------------------


@BOTH
def test_spreads_queries_over_healthy_replicas(pkg):
    with fleet(pkg, 2, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        for _ in range(20):
            assert http("POST", f"{base}/queries.json", {"user": "1"})[0] == 200
        assert stubs[0].queries + stubs[1].queries == 20
        assert stubs[0].queries >= 1 and stubs[1].queries >= 1


@BOTH
def test_dead_replica_is_absorbed_by_passive_ejection(pkg):
    """Health polls 30 s apart, so only the breaker, fed by live request
    failures, can eject the dark replica: one that accepts a query and
    never answers, the worst case of a kill, surfaced by the per-try
    timeout. The live replica's EWMA is seeded far above the dark one's,
    so P2C (which samples both of two) must pick the dark replica until
    its breaker opens after ``breaker_threshold`` (3) failures; every
    client request still gets 200 through the retry, and afterwards the
    dark replica gets nothing."""
    with fleet(pkg, 2, {"hedge": False, "health_interval": 30.0,
                        "per_try_timeout_ms": 300.0}) as (router, stubs, threads, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        dark, live = replica_of(router, stubs[0]), replica_of(router, stubs[1])
        assert dark.state == live.state == "ok"
        stubs[0].latency = 2.0                    # stub-0 goes dark
        dark.ewma_sec, live.ewma_sec = 1e-3, 1.0
        failures0 = cval(router._m_attempts, dark.name, "error")
        for i in range(3):
            assert dark.breaker.state == "closed"
            assert http("POST", f"{base}/queries.json", {})[0] == 200
            assert cval(router._m_attempts, dark.name, "error") == failures0 + i + 1
        assert dark.breaker.state == "open"
        assert stubs[1].queries == 3
        for _ in range(5):
            assert http("POST", f"{base}/queries.json", {})[0] == 200
        assert cval(router._m_attempts, dark.name, "error") == failures0 + 3
        assert stubs[1].queries == 8


@BOTH
def test_injected_replica_down_is_retried_to_200(pkg):
    with fleet(pkg, 2, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        assert http("POST", f"{base}/queries.json", {})[0] == 200
        before = cval(router._m_retries, "transport", "-")
        PKG[pkg].faults.arm("router.replica.down", error="replica gone", count=1)
        assert http("POST", f"{base}/queries.json", {})[0] == 200
        assert cval(router._m_retries, "transport", "-") == before + 1


@BOTH
def test_transient_500s_are_retried_until_success(pkg):
    with fleet(pkg, 1, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        stubs[0].fail_first = 2
        before = cval(router._m_retries, "500", "-")
        assert http("POST", f"{base}/queries.json", {})[0] == 200
        assert stubs[0].queries == 3
        assert cval(router._m_retries, "500", "-") == before + 2


# -- retry policy -----------------------------------------------------------------


@BOTH
def test_non_idempotent_post_is_never_retried(pkg):
    with fleet(pkg, 1, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        stubs[0].query_status = 500
        before = cval(router._m_retry_denied, "non_idempotent", "-")
        code, _ = http("POST", f"{base}/events.json", {"event": "buy"})
        assert code == 500
        assert stubs[0].events == 1
        assert cval(router._m_retry_denied, "non_idempotent", "-") == before + 1


@BOTH
def test_retry_budget_caps_amplification(pkg):
    with fleet(pkg, 1, {"hedge": False, "retry_budget_ratio": 0.0,
                        "retry_budget_burst": 1.0}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        stubs[0].query_status = 500
        denied = cval(router._m_retry_denied, "budget", "-")
        assert http("POST", f"{base}/queries.json", {})[0] == 500
        assert stubs[0].queries == 2       # the original and one budgeted retry
        assert cval(router._m_retry_denied, "budget", "-") >= denied + 1
        assert http("POST", f"{base}/queries.json", {})[0] == 500
        code, body, headers = http_full("POST", f"{base}/queries.json", {})
        assert code == 503 and "no replica available" in body["message"]
        assert int(headers["Retry-After"]) >= 1


@BOTH
def test_replica_retry_after_is_honored(pkg):
    with fleet(pkg, 2, {"hedge": False, "health_interval": 30.0}) as (
            router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        stubs[0].query_status = 503
        stubs[0].query_retry_after = "30"
        # the throttling replica is the one P2C prefers
        replica_of(router, stubs[0]).ewma_sec = 1e-3
        replica_of(router, stubs[1]).ewma_sec = 1.0
        assert http("POST", f"{base}/queries.json", {})[0] == 200
        assert stubs[0].queries == 1
        assert replica_of(router, stubs[0]).backoff_until > 0
        for _ in range(10):
            assert http("POST", f"{base}/queries.json", {})[0] == 200
        assert stubs[0].queries == 1      # inside its Retry-After window


# -- hedging ----------------------------------------------------------------------


@BOTH
def test_slow_primary_is_hedged_first_answer_wins(pkg):
    with fleet(pkg, 2, {"hedge_min_ms": 30.0}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        assert http("POST", f"{base}/queries.json", {})[0] == 200
        won = cval(router._m_hedges, "won", "-")
        launched = cval(router._m_hedges, "launched", "-")
        PKG[pkg].faults.arm("router.replica.slow", latency=3.0, count=1)
        t0 = time.perf_counter()
        code, _ = http("POST", f"{base}/queries.json", {})
        elapsed = time.perf_counter() - t0
        assert code == 200
        assert elapsed < 2.5              # the hedge answered, not the stall
        assert cval(router._m_hedges, "launched", "-") == launched + 1
        assert cval(router._m_hedges, "won", "-") == won + 1


# -- health and identity ----------------------------------------------------------


@BOTH
def test_health_flap_marks_down_then_recovers(pkg):
    with fleet(pkg, 2, {"hedge": False, "health_interval": 30.0}) as (
            router, stubs, _, rt):
        base = f"http://127.0.0.1:{router.http.port}"
        assert http("GET", f"{base}/health")[0] == 200
        PKG[pkg].faults.arm("router.health.flap", error="partitioned")
        on_loop(rt, router._poll_all())
        assert all(r.state == "ok" for r in router.replicas)   # one blip
        on_loop(rt, router._poll_all())
        assert all(r.state == "down" for r in router.replicas)
        code, body, headers = http_full("GET", f"{base}/health")
        assert code == 503 and body["status"] == "not-ready"
        assert int(headers["Retry-After"]) >= 1
        assert http("POST", f"{base}/queries.json", {})[0] == 503
        PKG[pkg].faults.disarm()
        on_loop(rt, router._poll_all())
        assert all(r.state == "ok" for r in router.replicas)
        assert http("POST", f"{base}/queries.json", {})[0] == 200


@BOTH
def test_restarted_replica_identity_resets_breaker_and_ewma(pkg):
    with fleet(pkg, 1, {"hedge": False, "health_interval": 30.0}) as (
            router, stubs, _, rt):
        rep = router.replicas[0]
        assert rep.instance == "stub-0"
        for _ in range(3):
            rep.breaker.record_failure()
        rep.ewma_sec = 1.5
        assert rep.breaker.state == "open"
        on_loop(rt, router._poll_all())
        assert rep.breaker.state == "open"          # same process: no pardon
        stubs[0].instance = "stub-0-reborn"
        on_loop(rt, router._poll_all())
        assert rep.instance == "stub-0-reborn"
        assert rep.breaker.state == "closed" and rep.ewma_sec == 0.0
        base = f"http://127.0.0.1:{router.http.port}"
        assert http("POST", f"{base}/queries.json", {})[0] == 200


@BOTH
def test_not_ready_health_backs_off_by_its_hint(pkg):
    with fleet(pkg, 2, {"hedge": False, "health_interval": 30.0}) as (
            router, stubs, _, rt):
        stubs[0].health_status = "not-ready"
        stubs[0].health_retry_after = 30.0
        on_loop(rt, router._poll_all())
        rep = replica_of(router, stubs[0])
        assert rep.state == "not-ready" and rep.backoff_until > 0
        base = f"http://127.0.0.1:{router.http.port}"
        for _ in range(5):
            assert http("POST", f"{base}/queries.json", {})[0] == 200
        assert stubs[0].queries == 0


@BOTH
def test_ready_replica_leaves_its_not_ready_backoff(pkg):
    """A replica that answered not-ready with a 30 s hint, then ok: the
    port's router routes to it at once (the hint estimated a warm-up
    that is over), so a rolling reload that re-admits it and drains the
    other serves 0 errors; the JAX router keeps the stale window, which
    left no replica in rotation during a rolling reload on the card
    (ROADMAP.md §3)."""
    with fleet(pkg, 2, {"hedge": False, "health_interval": 30.0, "drain_timeout": 5.0,
                        "ready_timeout": 10.0}) as (router, stubs, _, rt):
        rep = replica_of(router, stubs[0])
        stubs[0].health_status = "not-ready"
        stubs[0].health_retry_after = 30.0
        on_loop(rt, router._poll_all())
        assert rep.state == "not-ready" and rep.backoff_until > 0
        stubs[0].health_status = "ok"
        on_loop(rt, router._poll_all())
        assert rep.state == "ok"
        if pkg == "jax":
            assert rep.backoff_until > 0
            return
        assert rep.backoff_until == 0.0
        base = f"http://127.0.0.1:{router.http.port}"
        stop = threading.Event()
        statuses = []

        def hammer():
            while not stop.is_set():
                statuses.append(http("POST", f"{base}/queries.json", {})[0])

        t = threading.Thread(target=hammer)
        t.start()
        try:
            code, body, _ = http_full("POST", f"{base}/router/reload?rolling=1", timeout=60)
        finally:
            wait_until(lambda: len(statuses) > 5, timeout=5)
            stop.set()
            t.join(timeout=10)
        assert code == 200 and body["ok"] is True
        assert statuses and set(statuses) == {200}
        assert stubs[0].queries > 0


# -- propagation ------------------------------------------------------------------


@BOTH
def test_deadline_shrinks_and_trace_headers_flow_through(pkg):
    with fleet(pkg, 1, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        code, body = http("POST", f"{base}/queries.json", {"user": "1"},
                          headers={"X-PIO-Deadline-Ms": "5000", "traceparent": tp,
                                   "X-PIO-Trace-Id": "trace-42", "X-PIO-App": "shop"})
        assert code == 200
        seen = body["seen"]
        assert 4000 < float(seen["x-pio-deadline-ms"]) < 5000
        assert seen["traceparent"] == tp
        assert seen["x-pio-trace-id"] == "trace-42"
        assert seen["x-pio-app"] == "shop"


# -- rolling reload -----------------------------------------------------------------


@BOTH
def test_rolling_reload_serves_zero_errors(pkg):
    with fleet(pkg, 3, {"hedge": False, "health_interval": 0.2,
                        "drain_timeout": 5.0, "ready_timeout": 10.0}) as (
            router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        assert http("POST", f"{base}/queries.json", {})[0] == 200
        stop = threading.Event()
        statuses = []

        def hammer():
            while not stop.is_set():
                statuses.append(http("POST", f"{base}/queries.json", {})[0])

        t = threading.Thread(target=hammer)
        t.start()
        try:
            code, body, _ = http_full("POST", f"{base}/router/reload?rolling=1",
                                      timeout=60)
        finally:
            wait_until(lambda: len(statuses) > 5, timeout=5)
            stop.set()
            t.join(timeout=10)
        assert code == 200 and body["ok"] is True and body["rolling"] is True
        assert len(body["replicas"]) == 3
        assert all(e["result"] == "ok" and e["reloadGeneration"] == 1
                   for e in body["replicas"])
        assert all(s.reloads == 1 for s in stubs)
        assert statuses and set(statuses) == {200}


@BOTH
def test_non_rolling_reload_hits_every_replica(pkg):
    with fleet(pkg, 2, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        code, body, _ = http_full("POST", f"{base}/router/reload", timeout=60)
        assert code == 200 and body["ok"] is True and body["rolling"] is False
        assert all(s.reloads == 1 for s in stubs)


# -- endpoints and the manifest --------------------------------------------------------


@BOTH
def test_status_root_and_metrics(pkg):
    with fleet(pkg, 2, {"hedge": False}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        code, body = http("GET", f"{base}/")
        assert code == 200 and body == {"status": "router", "replicas": 2,
                                        "available": 2}
        code, body = http("GET", f"{base}/router/status")
        assert code == 200
        snaps = {s["url"]: s for s in body["replicas"]}
        assert set(snaps) == {f"http://{s.url}" for s in stubs}
        for i, s in enumerate(stubs):
            snap = snaps[f"http://{s.url}"]
            assert (snap["state"], snap["instance"], snap["breaker"]) == (
                "ok", f"stub-{i}", "closed")
        assert body["retryBudgetTokens"] > 0
        text = http_text(f"{base}/metrics")
        for name in ("pio_router_replica_state", "pio_router_retry_budget_remaining",
                     "pio_router_replica_seconds", "pio_build_info"):
            assert name in text


@BOTH
def test_manifest_watch_adds_and_removes_replicas(pkg, tmp_path):
    p = PKG[pkg]
    s1 = StubReplica(p, free_port(), instance="m-0")
    s2 = StubReplica(p, free_port(), instance="m-1")
    manifest = tmp_path / "fleet.txt"
    manifest.write_text(f"# fleet\n{s1.url}\n")
    with ServerThread(s1), ServerThread(s2):
        router = p.router.FleetRouter(manifest=str(manifest), host="127.0.0.1",
                                      port=free_port(), hedge=False,
                                      health_interval=30.0)
        with ServerThread(router) as rt:
            assert [r.name for r in router.replicas] == [s1.url]
            manifest.write_text(f"{s1.url}\n{s2.url}\n")
            os.utime(manifest, (time.time() + 5, time.time() + 5))
            on_loop(rt, router._poll_all())
            assert [r.name for r in router.replicas] == [s1.url, s2.url]
            assert all(r.state == "ok" for r in router.replicas)
            manifest.write_text(f"{s2.url}\n")
            os.utime(manifest, (time.time() + 10, time.time() + 10))
            on_loop(rt, router._poll_all())
            assert [r.name for r in router.replicas] == [s2.url]
            base = f"http://127.0.0.1:{router.http.port}"
            code, body = http("POST", f"{base}/queries.json", {})
            assert code == 200 and body["instance"] == "m-1"


@BOTH
def test_manifest_observers_are_federated_never_routed(pkg, tmp_path):
    p = PKG[pkg]
    serving = StubReplica(p, free_port(), instance="serve")
    watched = StubReplica(p, free_port(), instance="watch")
    watched.metrics_text = "pio_trainer_generation 7\n"
    manifest = tmp_path / "fleet.txt"
    manifest.write_text(f"{serving.url}\n{watched.url} observe=1\n")
    with ServerThread(serving), ServerThread(watched):
        router = p.router.FleetRouter(manifest=str(manifest), host="127.0.0.1",
                                      port=free_port(), hedge=False,
                                      health_interval=30.0)
        with ServerThread(router) as rt:
            assert [r.name for r in router.replicas] == [serving.url]
            assert [r.name for r in router.observers] == [watched.url]
            base = f"http://127.0.0.1:{router.http.port}"
            for _ in range(4):
                assert http("POST", f"{base}/queries.json", {})[0] == 200
            assert (serving.queries, watched.queries) == (4, 0)
            on_loop(rt, router._observe_tick())
            code, top, _ = http_full("GET", f"{base}/top?window=1m")
            assert code == 200 and top["trainer"]["generation"] == 7.0
            assert [o["url"] for o in top["observers"]] == [f"http://{watched.url}"]


@BOTH
def test_no_replica_answers_503_never_a_fallback(pkg):
    dead = free_port()
    router = PKG[pkg].router.FleetRouter([f"127.0.0.1:{dead}"], host="127.0.0.1",
                                         port=free_port(), hedge=False,
                                         health_interval=30.0, connect_timeout_ms=100)
    with ServerThread(router) as rt:
        on_loop(rt, router._poll_all())
        base = f"http://127.0.0.1:{router.http.port}"
        code, body, headers = http_full("POST", f"{base}/queries.json", {"user": "1"})
        assert code == 503 and body == {"message": "no replica available"}
        assert int(headers["Retry-After"]) >= 1
        code, body, _ = http_full("GET", f"{base}/health")
        assert code == 503 and body["available"] == 0


# -- the manifest's variant pins (tests/test_variants.py TestRouterVariantPins) ----------


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@BOTH
def test_manifest_pins_are_pushed_idempotently(pkg, tmp_path):
    mod = PKG[pkg].router
    manifest = tmp_path / "fleet.txt"
    manifest.write_text("# fleet\n127.0.0.1:18000 variants=champion:9,challenger:1\n"
                        "127.0.0.1:18001\n")
    router = mod.FleetRouter(manifest=str(manifest), host="127.0.0.1",
                             port=free_port(), hedge=False)
    pushed = []
    router._post_weights = lambda url, w: pushed.append((url, dict(w)))
    assert router._variant_pins == {
        "127.0.0.1:18000": {"champion": 9.0, "challenger": 1.0}}
    _run(router._push_variant_pins())
    assert pushed == []                 # not while the replica is down
    for rep in router.replicas:
        rep.state = mod.OK
    _run(router._push_variant_pins())
    _run(router._push_variant_pins())
    assert pushed == [("http://127.0.0.1:18000", {"champion": 9.0, "challenger": 1.0})]
    manifest.write_text("127.0.0.1:18000 variants=champion:1\n127.0.0.1:18001\n")
    router._manifest_urls()
    _run(router._push_variant_pins())
    assert pushed[-1] == ("http://127.0.0.1:18000", {"champion": 1.0})
    assert len(pushed) == 2


@BOTH
def test_push_failure_is_retried_next_tick(pkg, tmp_path):
    mod = PKG[pkg].router
    manifest = tmp_path / "fleet.txt"
    manifest.write_text("127.0.0.1:18000 variants=champion:1\n")
    router = mod.FleetRouter(manifest=str(manifest), host="127.0.0.1",
                             port=free_port(), hedge=False)
    for rep in router.replicas:
        rep.state = mod.OK
    calls = []

    def post(url, w):
        calls.append(url)
        if len(calls) == 1:
            raise OSError("replica restarting")

    router._post_weights = post
    for _ in range(3):
        _run(router._push_variant_pins())
    assert len(calls) == 2


@BOTH
def test_bad_pin_never_takes_the_manifest_down(pkg, tmp_path):
    manifest = tmp_path / "fleet.txt"
    manifest.write_text("127.0.0.1:18000 variants=:::garbage\n")
    router = PKG[pkg].router.FleetRouter(manifest=str(manifest), host="127.0.0.1",
                                         port=free_port(), hedge=False)
    assert [r.name for r in router.replicas] == ["127.0.0.1:18000"]
    assert router._variant_pins == {}


# -- real engine servers behind each package's router ------------------------------------


@pytest.fixture(scope="module")
def jax_home(tmp_path_factory):
    """One home with a JAX-trained recommendation instance (30 users,
    20 items, rank 8), which both packages' engine servers serve."""
    home = str(tmp_path_factory.mktemp("router_home"))
    st = JaxStorage(JaxStorageConfig(home=home))
    seed_ratings(st)
    jax_run_train(FACTORY, variant=VARIANT, storage=st, use_mesh=False)
    return home


@contextlib.contextmanager
def engine_fleet(pkg, home, n=2, router_kwargs=None, engine_kwargs=None):
    """n engine servers of package ``pkg`` on ``home`` (the port's on the
    CPU) behind that package's router. Yields (router, engines, router
    thread)."""
    jax = pkg == "jax"
    with contextlib.ExitStack() as stack:
        engines = []
        for _ in range(n):
            st = (JaxStorage(JaxStorageConfig(home=home)) if jax
                  else Storage(StorageConfig(home=home)))
            kw = dict(engine_kwargs or {}, **({} if jax else {"device": "cpu"}))
            srv = (JaxEngineServer if jax else EngineServer)(
                engine_factory=FACTORY, storage=st, host="127.0.0.1",
                port=free_port(), **kw)
            stack.enter_context(ServerThread(srv))
            engines.append(srv)
        router = PKG[pkg].router.FleetRouter(
            [f"127.0.0.1:{e.http.port}" for e in engines], host="127.0.0.1",
            port=free_port(), **dict({"hedge": False, "health_interval": 30.0,
                                      "probe_interval": 0.0}, **(router_kwargs or {})))
        rt = stack.enter_context(ServerThread(router))
        yield router, engines, rt


QUERIES = [{"user": str(u), "num": k} for u in range(30) for k in (3, 7)]


def _answers_agree(a, b):
    """The serving rule: equal ids except near-ties within 1e-5 of the
    scale (where the order of equal-to-f32 scores may differ), scores
    within rtol 1e-5."""
    sa = np.array([s["score"] for s in a["itemScores"]])
    sb = np.array([s["score"] for s in b["itemScores"]])
    if len(sa) != len(sb):
        return False
    if not np.allclose(sa, sb, rtol=1e-5, atol=1e-6):
        return False
    tie = 1e-5 * max(1.0, float(np.abs(sa).max(initial=0.0)))
    for j, (x, y) in enumerate(zip(a["itemScores"], b["itemScores"])):
        if x["item"] == y["item"]:
            continue
        near = [k for k in range(len(sa)) if abs(sa[k] - sa[j]) <= tie]
        if len(near) < 2 or y["item"] not in {a["itemScores"][k]["item"] for k in near}:
            return False
    return True


def test_port_fleet_answers_as_the_jax_fleet(jax_home):
    """The same queries through the port router over two port engine
    servers and through the JAX router over two JAX engine servers, on
    one instance: the same answers under the serving rule, every query
    200, and both port replicas serve."""
    out = {}
    for pkg in ("jax", "port"):
        with engine_fleet(pkg, jax_home) as (router, engines, _rt):
            base = f"http://127.0.0.1:{router.http.port}"
            out[pkg] = [http("POST", f"{base}/queries.json", q) for q in QUERIES]
            status = http("GET", f"{base}/router/status")[1]
            assert [r["state"] for r in status["replicas"]] == ["ok", "ok"]
            assert all(r["ewmaMs"] > 0 for r in status["replicas"])
    assert all(code == 200 for code, _ in out["jax"] + out["port"])
    bad = [q for q, (_, a), (_, b) in zip(QUERIES, out["jax"], out["port"])
           if not _answers_agree(a, b)]
    assert bad == []
    assert all(len(b["itemScores"]) == q["num"] for q, (_, b) in zip(QUERIES, out["port"]))


def _shape(doc):
    """The keys of a JSON document, recursively (lists by their first
    element), with the values left out."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [_shape(doc[0])] if doc else []
    return type(doc).__name__ if doc is not None else None


def _history_names(base):
    code, doc, _ = http_full("GET", f"{base}/metrics/history")
    assert code == 400
    return set(doc["names"])


def test_federation_top_and_slo_match_the_jax_router(jax_home, tmp_path):
    """Two engine servers behind each package's router on one instance,
    the same traffic and prober canaries, then the router's own tick
    (federation and SLO evaluation): ``/top?window=5m`` and
    ``/slo/status`` have the same keys, series names and replica fields,
    and the federated ``pio_fleet_*`` series that ``/top`` and
    ``conf/slo.json``'s selectors read exist in both routers' history."""
    docs = {}
    for pkg in ("jax", "port"):
        with engine_fleet(pkg, jax_home, router_kwargs={"scrape_interval": 3600.0}) as (
                router, engines, rt):
            base = f"http://127.0.0.1:{router.http.port}"
            for q in QUERIES[:20]:
                assert http("POST", f"{base}/queries.json", q)[0] == 200
            probe0 = cval(router._m_probe, "/queries.json", "ok")
            for _ in range(3):
                on_loop(rt, router._probe_once())
            # the canary {"user": "pio-probe", "num": 1} is answered 200
            assert cval(router._m_probe, "/queries.json", "ok") == probe0 + 3
            for _ in range(2):
                router.tsdb.scrape()
                on_loop(rt, router._observe_tick())
                time.sleep(0.05)
            code, top, _ = http_full("GET", f"{base}/top?window=5m")
            assert code == 200
            code, slo, _ = http_full("GET", f"{base}/slo/status")
            assert code == 200
            names = _history_names(base)
            docs[pkg] = {"top": top, "slo": slo, "names": names,
                         "metrics": http_text(f"{base}/metrics")}
    jax, port = docs["jax"], docs["port"]
    assert _shape(port["top"]) == _shape(jax["top"])
    assert _shape(port["slo"]) == _shape(jax["slo"])
    assert [s["name"] for s in port["slo"]["slos"]] == [s["name"] for s in jax["slo"]["slos"]]
    assert port["slo"]["fastBurning"] == jax["slo"]["fastBurning"] == []
    # the registries are process-global: other cases' series may show too
    for side in (jax, port):
        assert "/queries.json" in side["top"]["paths"]
        assert "200" in side["top"]["qps"]["byStatus"]
        assert "ok" in side["top"]["probe"]
        assert sorted(side["top"]["paths"]["/queries.json"]) == ["p50Ms", "p99Ms", "qps"]
    for side in (jax, port):
        assert [sorted(r) for r in side["top"]["replicas"]] == [
            sorted(port["top"]["replicas"][0])] * 2
    # every series /top and the SLOs read, where the JAX router has it
    read = {"pio_router_requests_total", "pio_router_path_seconds_count",
            "pio_probe_requests_total", "pio_probe_seconds_bucket",
            "pio_fleet_variant_requests_total", "pio_fleet_engine_shed_total",
            "pio_fleet_trainer_cycles_total"}
    assert {n for n in read if n in jax["names"]} == {n for n in read if n in port["names"]}
    # the replicas' own families, summed into pio_fleet_*
    fleet_jax = {n for n in jax["names"] if n.startswith("pio_fleet_engine_")}
    fleet_port = {n for n in port["names"] if n.startswith("pio_fleet_engine_")}
    assert fleet_jax and fleet_port == fleet_jax
    for side in (jax, port):
        assert 'pio_fleet_engine_queries_total{status="200"}' in side["metrics"]


# -- the continuous trainer's pushes against a live port router ---------------------------


def _stub_trainer(tmp_path, **cfg):
    storage = Storage(StorageConfig(home=str(tmp_path / "trainer_home")))
    return port_trainer.ContinuousTrainer(
        port_trainer.TrainerConfig(engine_factory="stub:factory", app_name="LoopApp",
                                   **cfg), storage=storage)


def test_trainer_router_url_push_rolls_the_live_port_fleet(tmp_path):
    with fleet("port", 2, {"hedge": False, "health_interval": 30.0,
                           "ready_timeout": 10.0}) as (router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        trainer = _stub_trainer(tmp_path, router_url=base)
        rolling0 = cval(router._m_rolling, "ok")
        assert trainer._push_reload() is True
        assert [s.reloads for s in stubs] == [1, 1]
        assert cval(router._m_rolling, "ok") == rolling0 + 1
        status = http("GET", f"{base}/router/status")[1]
        assert [r["reloadGeneration"] for r in status["replicas"]] == [1, 1]
        # a router that refuses (a replica that cannot reload) fails the push
        stubs[1].reload_status = 500
        assert trainer._push_reload() is False


def test_trainer_fleet_manifest_reads_the_live_router_status(tmp_path):
    """``fleet_manifest`` takes a ``/router/status`` document: the trainer
    reloads each replica it names directly."""
    with fleet("port", 2, {"hedge": False, "health_interval": 30.0}) as (
            router, stubs, _, _rt):
        base = f"http://127.0.0.1:{router.http.port}"
        manifest = tmp_path / "fleet.json"
        manifest.write_text(http_text(f"{base}/router/status"))
        trainer = _stub_trainer(tmp_path, fleet_manifest=str(manifest))
        assert trainer._replica_urls() == [f"http://{s.url}" for s in stubs]
        assert trainer._push_reload() is True
        assert [s.reloads for s in stubs] == [1, 1]
