"""The engine server's operations surface, and the event server's share
of it, held against the JAX package's servers on the CPU.

Every test runs one request script against a JAX server and a port
server (``device="cpu"``) on twin temporary homes: each home is seeded
with the same ratings, and each package trains its own instance with its
own ``Storage(StorageConfig(home=...))`` (never the shared ``storage``
fixture). Status codes, ``Retry-After``, body keys, ``lastSwap``
outcomes, ``reloadGeneration`` and the metric deltas must be equal. The
cases are those of ``tests/test_serving_resilience.py`` this slice ports
(``TestQueryDeadline``, ``TestLoadShedding``, ``TestHealth``,
``TestHardenedReload``, ``TestReplicaIdentity``, ``TestHopDeadline``),
plus ``/reload``'s refusal and warm-up rollback, ``/metrics`` families,
``/metrics/history``, ``/traces``, the access-log line, TLS on both
servers, the event server's ``/health``, ``/metrics`` and ``/traces``,
the registry-generation lookup, and the CLI flags that build the
servers. The port's own checks: a reload under load answers each query
from the factors of the engine that was asked, the candidate lands on
the server's device, and a same-geometry candidate warms from the cache
alone.
"""

import base64
import http.client
import json
import logging
import os
import pickle
import shutil
import ssl
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu.server.event_server import EventServer as JaxEventServer
from predictionio_tpu.server.ssl_config import ssl_context_from_env as jax_ssl
from predictionio_tpu.storage.models import model_registry as jax_model_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu.utils import tracing as jax_tracing
from predictionio_tpu.utils.metrics import REGISTRY as JAX_REGISTRY
from predictionio_tpu.utils.timeseries import parse_prom_text as jax_parse_prom
from predictionio_tpu_torch.core.workflow import (
    RECOMMENDATION_FACTORY,
    prepare_deploy,
)
from predictionio_tpu_torch.core.workflow import run_train as port_run_train
from predictionio_tpu_torch.server import aot as port_aot
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.server.ssl_config import ssl_context_from_env
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.models import find_gen
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.utils import faults as port_faults
from predictionio_tpu_torch.utils import tracing as port_tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY as PORT_REGISTRY
from predictionio_tpu_torch.utils.timeseries import parse_prom_text
from tests.test_torch_event_server import ServerThread
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_DIR = os.path.join(REPO, "predictionio_tpu_torch", "templates",
                          "recommendation")
PORT_VARIANT = dict(VARIANT, engineFactory=RECOMMENDATION_FACTORY)
#: the second instance a reload swaps to: other factors, same geometry
LAMBDA_2 = 0.5
QUERY = {"user": "2", "num": 3}

#: families of the JAX package's registry with a name the compared
#: prefixes cover that the port does not register in this script: the
#: sink redirects (the port imports its HTTP sink only for a feedback
#: URL), the native event log's shard appends (event-store backends), the
#: ES index of instances (storage)
JAX_ONLY_FAMILIES = {
    "pio_eventsink_redirects_total",
    "pio_eventlog_shard_appends_total",
    "pio_engine_instances",
}
COMPARED_PREFIXES = ("pio_engine_", "pio_aot_", "pio_predict_device_",
                     "pio_batcher_", "pio_events_", "pio_event_",
                     "pio_ingest_", "pio_trace_", "pio_tsdb_",
                     "pio_circuit_breaker_", "pio_build_info")


class Side:
    """One package's half of the twin: its home, storage, server classes,
    fault registry, tracer and metrics registry."""

    def __init__(self, name, home):
        self.name, self.home = name, home
        os.makedirs(home, exist_ok=True)
        jax = name == "jax"
        self.storage = (JaxStorage(JaxStorageConfig(home=home)) if jax
                        else Storage(StorageConfig(home=home)))
        self.Engine = JaxEngineServer if jax else EngineServer
        self.Events = JaxEventServer if jax else EventServer
        self.faults = jax_faults.FAULTS if jax else port_faults.FAULTS
        self.tracing = jax_tracing if jax else port_tracing
        self.registry = JAX_REGISTRY if jax else PORT_REGISTRY
        self.parse_prom = jax_parse_prom if jax else parse_prom_text
        self.ssl = jax_ssl if jax else ssl_context_from_env
        self.device_kw = {} if jax else {"device": "cpu"}

    def seed(self):
        # the same events in both homes, through one writer
        seed_ratings(JaxStorage(JaxStorageConfig(home=self.home)))

    def train(self, lam=0.05):
        variant = dict(VARIANT if self.name == "jax" else PORT_VARIANT)
        variant["algorithms"] = [{"name": "als", "params": {
            "rank": 8, "numIterations": 8, "lambda": lam}}]
        if self.name == "jax":
            return jax_run_train(FACTORY, variant=variant, storage=self.storage,
                                 use_mesh=False)
        return port_run_train(RECOMMENDATION_FACTORY, variant=variant,
                              storage=self.storage, device="cpu")

    def engine(self, **kw):
        return self.Engine(engine_factory=FACTORY, storage=self.storage,
                           host="127.0.0.1", port=0, **self.device_kw, **kw)


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    for v in ("PIO_SSL_CERT_PATH", "PIO_SSL_KEY_PATH"):
        monkeypatch.delenv(v, raising=False)
    out = [Side("jax", str(tmp_path / "jax")), Side("torch", str(tmp_path / "port"))]
    for s in out:
        s.faults.disarm()
        s.tracing.TRACER.reset()
    yield out
    for s in out:
        s.faults.disarm()
        s.tracing.TRACER.reset()


@pytest.fixture()
def trained(sides):
    for s in sides:
        s.seed()
        s.first = s.train()
    return sides


def call(port, method, path, body=None, headers=None, context=None,
         timeout=30):
    """One request on a new connection: (status, raw body, headers)."""
    if context is None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    else:
        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=timeout,
                                           context=context)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.headers
    finally:
        conn.close()


def jcall(port, method, path, body=None, headers=None, **kw):
    status, raw, hdrs = call(port, method, path, body, headers, **kw)
    return status, (json.loads(raw) if raw else None), hdrs


def keys(body):
    return sorted(body) if isinstance(body, dict) else body


def wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "condition not reached"
        time.sleep(0.01)


def both(sides, script):
    """Run ``script(side)`` on each side; returns {name: result}."""
    return {s.name: script(s) for s in sides}


def assert_same(out):
    assert out["torch"] == out["jax"], out


# -- TestQueryDeadline ---------------------------------------------------------


def test_hung_query_answers_504_within_the_deadline(trained):
    def script(s):
        srv = s.engine(query_timeout_ms=300)
        # the first answer of a cold JAX process compiles its scorer,
        # which alone can outlast 300 ms: serve one in-process first
        srv.deployed.query(QUERY)
        before = srv._m_deadline.get()
        with ServerThread(srv) as t:
            first = jcall(t.port, "POST", "/queries.json", QUERY)[0]
            s.faults.arm("serving.query", latency=3.0)
            t0 = time.perf_counter()
            code, body, _ = jcall(t.port, "POST", "/queries.json", QUERY)
            elapsed = time.perf_counter() - t0
            assert elapsed < 2.0 and "deadline" in body["message"]
            s.faults.disarm()
            after = jcall(t.port, "POST", "/queries.json", QUERY)[0]
        return first, code, keys(body), srv._m_deadline.get() - before, after

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (200, 504, ["message"], 1, 200)


def test_error_paths_still_observe_latency_metrics(trained):
    def script(s):
        srv = s.engine()

        def hist_total():
            return sum(sum(c) for _, c, _ in srv._m_latency.items())

        h0, q0 = hist_total(), srv._m_queries.get(("400",))
        with ServerThread(srv) as t:
            codes = [jcall(t.port, "POST", "/queries.json", b)[0]
                     for b in ({"nope": 1}, None)]
            codes.append(call(t.port, "POST", "/queries.json")[0])
        return codes, srv._m_queries.get(("400",)) - q0, hist_total() - h0

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == ([400, 400, 400], 3, 3)


# -- TestLoadShedding ----------------------------------------------------------


def _slow_then_shed(s, srv, t, headers=None):
    """With one slow query admitted, a second query's answer."""
    s.faults.arm("serving.query", latency=1.0)
    results = {}
    slow = threading.Thread(target=lambda: results.setdefault(
        "slow", jcall(t.port, "POST", "/queries.json", QUERY)))
    slow.start()
    wait_for(lambda: srv._inflight >= 1)
    t0 = time.perf_counter()
    code, body, hdrs = jcall(t.port, "POST", "/queries.json",
                             {"user": "3", "num": 3}, headers=headers)
    shed_s = time.perf_counter() - t0
    slow.join(timeout=10)
    s.faults.disarm()
    return code, body, hdrs, shed_s, results["slow"][0]


@pytest.mark.parametrize("app", ["", "tenantA"])
def test_past_the_cap_sheds_503_with_retry_after(trained, app):
    def script(s):
        srv = s.engine(max_inflight=1)
        label = app or "-"
        shed0, q0 = srv._m_shed.get((label,)), srv._m_queries.get(("503",))
        with ServerThread(srv) as t:
            code, body, hdrs, shed_s, slow = _slow_then_shed(
                s, srv, t, headers={"X-PIO-App": app} if app else None)
        assert shed_s < 0.5 and "overloaded" in body["message"]
        return (code, keys(body), int(hdrs["Retry-After"]) >= 1, slow,
                srv._m_shed.get((label,)) - shed0,
                srv._m_queries.get(("503",)) - q0)

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (503, ["message", "retryAfterSec"], True, 200, 1, 1)


def test_probe_header_takes_no_seat(trained):
    def script(s):
        srv = s.engine(max_inflight=1)
        with ServerThread(srv) as t:
            code, *_ = _slow_then_shed(s, srv, t, headers={"X-PIO-Probe": "1"})
        return code

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == 200


# -- TestHealth ----------------------------------------------------------------


def test_health_ok_when_serving_normally(trained):
    def script(s):
        with ServerThread(s.engine()) as t:
            code, body, _ = jcall(t.port, "GET", "/health")
        return code, body["status"], body["breakers"], keys(body), \
            body["modelGeneration"], body["lastSwap"], body["inflightByApp"]

    out = both(trained, script)
    assert_same(out)
    assert out["torch"][:2] == (200, "ok")
    assert out["torch"][2] == {"feedback_sink": "closed"}


def test_not_ready_without_an_engine_then_reload_recovers(sides):
    def script(s):
        s.seed()
        srv = s.engine(require_engine=False)
        with ServerThread(srv) as t:
            h = jcall(t.port, "GET", "/health")
            q = jcall(t.port, "POST", "/queries.json", {"user": "1", "num": 2})
            status = jcall(t.port, "GET", "/")[1]
            iid = s.train()
            r = jcall(t.port, "GET", "/reload")
            h2 = jcall(t.port, "GET", "/health")[1]
            q2 = jcall(t.port, "POST", "/queries.json", QUERY)[0]
        assert r[1]["engineInstanceId"] == iid
        assert h2["lastSwap"]["engineInstanceId"] == iid
        return (h[0], h[1]["status"], keys(h[1]), "Retry-After" in h[2],
                q[0], keys(q[1]), "Retry-After" in q[2], keys(status),
                r[0], keys(r[1]), r[1]["swap"], r[1]["reloadGeneration"],
                h2["status"], h2["reloadGeneration"], h2["lastSwap"]["outcome"],
                q2)

    out = both(sides, script)
    assert_same(out)
    assert out["torch"][:2] == (503, "not-ready")
    assert out["torch"][8] == 200 and out["torch"][-4:] == ("ok", 1, "promoted", 200)


def test_degraded_while_a_breaker_is_open_stays_200(trained):
    def script(s):
        srv = s.engine()
        with ServerThread(srv) as t:
            for _ in range(5):
                srv._sink_breaker.record_failure()
            code, body, _ = jcall(t.port, "GET", "/health")
            srv._sink_breaker.reset()
        return code, body["status"], body["reason"], body["breakers"]

    out = both(trained, script)
    assert_same(out)
    assert out["torch"][:3] == (200, "degraded", "breaker open: feedback_sink")


def test_degraded_at_inflight_capacity(trained):
    def script(s):
        srv = s.engine(max_inflight=1)
        with ServerThread(srv) as t:
            s.faults.arm("serving.query", latency=1.0)
            slow = threading.Thread(target=lambda: jcall(
                t.port, "POST", "/queries.json", QUERY))
            slow.start()
            wait_for(lambda: srv._inflight >= 1)
            code, body, _ = jcall(t.port, "GET", "/health")
            slow.join(timeout=10)
            s.faults.disarm()
        return code, body["status"], body["reason"], body["inflight"]

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (200, "degraded", "at inflight capacity", 1)


# -- TestHardenedReload --------------------------------------------------------


def test_reload_under_load_never_serves_an_error(trained):
    def script(s):
        srv = s.engine()
        with ServerThread(srv) as t:
            assert jcall(t.port, "POST", "/queries.json", QUERY)[0] == 200
            second = s.train(LAMBDA_2)
            stop = threading.Event()
            statuses = []

            def hammer():
                while not stop.is_set():
                    statuses.append(jcall(t.port, "POST", "/queries.json",
                                          QUERY)[0])

            h = threading.Thread(target=hammer)
            h.start()
            try:
                code, body, _ = jcall(t.port, "GET", "/reload")
            finally:
                time.sleep(0.2)
                stop.set()
                h.join(timeout=10)
            health = jcall(t.port, "GET", "/health")[1]
        assert body["engineInstanceId"] == second
        assert health["lastSwap"]["engineInstanceId"] == second
        return (code, keys(body), body["reloadGeneration"], body["swap"],
                set(statuses), health["lastSwap"]["outcome"],
                health["reloadGeneration"], srv._m_reload_gen.get())

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (200, ["engineInstanceId", "message", "modelGeneration",
                                  "reloadGeneration", "swap"],
                            1, "promoted", {200}, "promoted", 1, 1)


def test_probe_failure_rolls_back_to_last_good_engine(trained):
    def script(s):
        srv = s.engine()
        rb0 = srv._m_reloads.get(("rolled_back",))
        with ServerThread(srv) as t:
            assert jcall(t.port, "POST", "/queries.json", QUERY)[0] == 200
            s.train(LAMBDA_2)
            s.faults.arm("serving.reload", error="candidate cannot serve")
            code, body, _ = jcall(t.port, "GET", "/reload")
            kept = jcall(t.port, "GET", "/")[1]["engineInstanceId"]
            q = jcall(t.port, "POST", "/queries.json", QUERY)[0]
            swap = jcall(t.port, "GET", "/health")[1]["lastSwap"]
            s.faults.disarm()
            code2, body2, _ = jcall(t.port, "GET", "/reload")
        assert body["engineInstanceId"] == kept == s.first
        assert body2["engineInstanceId"] != s.first
        return (code, keys(body), "rolled back" in body["message"], body["swap"],
                q, swap["outcome"], swap["reason"],
                srv._m_reloads.get(("rolled_back",)) - rb0, code2,
                body2["reloadGeneration"])

    out = both(trained, script)
    assert_same(out)
    assert out["torch"][0] == 500 and out["torch"][3:] == (
        "rolled_back", 200, "rolled_back", "probe query failed", 1, 200, 1)


def test_reload_refused_when_the_candidate_does_not_load(sides):
    def script(s):
        srv = s.engine(require_engine=False)
        f0 = srv._m_reloads.get(("failed",))
        with ServerThread(srv) as t:
            code, body, _ = jcall(t.port, "GET", "/reload")
            health = jcall(t.port, "GET", "/health")[1]
        return (code, keys(body), body["swap"], health["lastSwap"]["outcome"],
                sorted(health["lastSwap"]), health["reloadGeneration"],
                srv._m_reloads.get(("failed",)) - f0)

    out = both(sides, script)
    assert_same(out)
    assert out["torch"][0] == 500 and out["torch"][2:4] == ("refused", "refused")


def test_warmup_failure_rolls_back(trained):
    def script(s):
        srv = s.engine(aot_buckets="1,2")
        assert srv._warmup.wait(60) and srv._warmup.ready
        with ServerThread(srv) as t:
            s.train(LAMBDA_2)

            def broken(deployed):
                raise RuntimeError("no memory for the candidate")

            srv._warmup.warm_sync = broken
            code, body, _ = jcall(t.port, "GET", "/reload")
            swap = jcall(t.port, "GET", "/health")[1]["lastSwap"]
            q = jcall(t.port, "POST", "/queries.json", QUERY)[0]
        assert body["engineInstanceId"] == s.first
        return code, body["swap"], "aot warmup failed" in body["message"], \
            swap["outcome"], swap["reason"], q

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (500, "rolled_back", True, "rolled_back",
                            "aot warmup failed", 200)


def test_reload_answers_come_from_the_engine_that_was_asked(trained):
    """Port: a reload under a batching load with an AOT ladder serves
    each answer from the old or the new factors (never a mix), every
    answer after the reload's 200 from the new ones; the same-geometry
    candidate adopts the cached programs and builds none, and it lands
    on the server's device."""
    s = trained[1]
    srv = s.engine(batching=True, batch_max=8, aot_buckets="1,2,4,8")
    assert srv._warmup.wait(60) and srv._warmup.ready
    second = s.train(LAMBDA_2)
    users = [str(u) for u in range(12)]
    engines = {iid: prepare_deploy(instance_id=iid, storage=s.storage,
                                   device="cpu") for iid in (s.first, second)}
    want = {iid: {u: eng.query({"user": u, "num": 5}) for u in users}
            for iid, eng in engines.items()}
    assert want[s.first] != want[second]
    answers, stop = [], threading.Event()
    with ServerThread(srv) as t:
        assert jcall(t.port, "POST", "/queries.json", QUERY)[0] == 200

        def hammer(c):
            i = c
            while not stop.is_set():
                u = users[i % len(users)]
                sent = time.perf_counter()
                code, body, _ = jcall(t.port, "POST", "/queries.json",
                                      {"user": u, "num": 5})
                answers.append((sent, u, code, body))
                i += 1

        threads = [threading.Thread(target=hammer, args=(c,)) for c in range(4)]
        for h in threads:
            h.start()
        time.sleep(0.1)
        counts0 = port_aot.EXECUTABLES.counts()
        code, body, _ = jcall(t.port, "GET", "/reload")
        swapped = time.perf_counter()
        counts1 = port_aot.EXECUTABLES.counts()
        time.sleep(0.2)
        stop.set()
        for h in threads:
            h.join(timeout=10)
    assert code == 200 and body["engineInstanceId"] == second
    assert srv.deployed.models[0]._device_scorer().device.type == "cpu"
    assert counts1.get("compile", 0) == counts0.get("compile", 0)
    assert counts1.get("hit", 0) > counts0.get("hit", 0)

    def close(a, b):
        return [x["item"] for x in a["itemScores"]] == \
            [x["item"] for x in b["itemScores"]] and np.allclose(
                [x["score"] for x in a["itemScores"]],
                [x["score"] for x in b["itemScores"]], rtol=1e-5)

    assert answers and {c for _, _, c, _ in answers} == {200}
    # a query sent after the reload's 200 is answered by the new engine
    for sent, u, _, got in answers:
        old, new = want[s.first][u], want[second][u]
        assert close(got, new) if sent > swapped else (
            close(got, old) or close(got, new))
    assert any(sent > swapped for sent, *_ in answers)


def test_warmup_mark_ready_release_and_cache_counts():
    """AOTWarmup.mark_ready/release and ExecutableCache.counts/clear: the
    same states and gauge in both packages; clear empties only the
    port's cache (its programs are rebuilt on the next warm-up)."""
    from predictionio_tpu.server import aot as jax_aot

    out = {}
    for name, mod, reg in (("jax", jax_aot, JAX_REGISTRY),
                           ("torch", port_aot, PORT_REGISTRY)):
        w = mod.AOTWarmup(mod.BucketLadder([1, 2]))
        gauge = reg.gauge("pio_aot_warmup_ready", "")
        states = [(w.state, gauge.get())]
        w.mark_ready()
        states.append((w.state, gauge.get(), w.ready, w.retry_after()))
        w.release()
        states.append((w.state, gauge.get()))
        counts = mod.EXECUTABLES.counts()
        out[name] = states, sorted(set(counts) - {"hit", "compile"})
    assert out["torch"] == out["jax"]
    assert out["torch"][0][1][:3] == ("ready", 1.0, True)
    built = []
    key = ("test-only", 1)
    port_aot.EXECUTABLES.get_or_compile(key, lambda: built.append(1) or "p")
    port_aot.EXECUTABLES.get_or_compile(key, lambda: built.append(1) or "p")
    port_aot.EXECUTABLES.clear()
    port_aot.EXECUTABLES.get_or_compile(key, lambda: built.append(1) or "p")
    port_aot.EXECUTABLES.clear()
    assert built == [1, 1]


# -- TestReplicaIdentity -------------------------------------------------------


def test_health_carries_stable_process_identity(trained):
    def script(s):
        srv = s.engine()
        with ServerThread(srv) as t:
            code, body, _ = jcall(t.port, "GET", "/health")
            again = jcall(t.port, "GET", "/health")[1]["instance"]
        assert body["instance"] == srv.instance_uid == again
        assert body["startedAt"] == round(srv.start_epoch, 3)
        build = [k for k, _ in srv.tsdb.registry.gauge(
            "pio_build_info", "", ("version", "instance")).items()
            if k[1] == srv.instance_uid]
        return code, len(body["instance"]), body["reloadGeneration"], len(build)

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (200, 12, 0, 1)


def test_not_ready_surfaces_identity_and_a_real_retry_hint(sides):
    def script(s):
        srv = s.engine(require_engine=False)
        with ServerThread(srv) as t:
            code, body, hdrs = jcall(t.port, "GET", "/health")
        assert body["instance"] == srv.instance_uid
        return code, body["status"], body["retryAfterSec"], hdrs["Retry-After"], \
            body["modelGeneration"]

    out = both(sides, script)
    assert_same(out)
    assert out["torch"] == (503, "not-ready", 1.0, "1", None)


def test_shed_503_hint_tracks_observed_latency(trained):
    def script(s):
        srv = s.engine(max_inflight=1)
        with ServerThread(srv) as t:
            assert jcall(t.port, "POST", "/queries.json", QUERY)[0] == 200
            ewma = srv._lat_ewma
            code, body, *_ = _slow_then_shed(s, srv, t)
        assert ewma > 0
        assert body["retryAfterSec"] == pytest.approx(max(0.1, 2.0 * ewma),
                                                      rel=0.5)
        return code

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == 503


# -- TestHopDeadline -----------------------------------------------------------


@pytest.mark.parametrize("hop, timeout_ms, want", [
    ("300", 30000, 504), ("bogus", 0, 200), ("0", 0, 200)])
def test_hop_deadline(trained, hop, timeout_ms, want):
    def script(s):
        srv = s.engine(query_timeout_ms=timeout_ms)
        with ServerThread(srv) as t:
            if want == 504:
                s.faults.arm("serving.query", latency=3.0)
            t0 = time.perf_counter()
            code, body, _ = jcall(t.port, "POST", "/queries.json", QUERY,
                                  headers={"X-PIO-Deadline-Ms": hop})
            assert time.perf_counter() - t0 < 2.0
            s.faults.disarm()
        return code, keys(body)

    out = both(trained, script)
    assert_same(out)
    assert out["torch"][0] == want


# -- /metrics, /metrics/history, /traces, access log ---------------------------


def _families(side, text):
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            if name.startswith(COMPARED_PREFIXES):
                out[name] = kind
    return out


def _samples(side, text):
    got = {}
    for name, labels, value in side.parse_prom(text):
        if name.startswith(COMPARED_PREFIXES) and not name.startswith(
                "pio_build_info") and "_bucket" not in name \
                and not name.endswith("_sum"):
            got[(name, tuple(sorted(labels.items())))] = value
    return got


def _metrics_script(s):
    srv = s.engine(batching=True, aot_buckets="1,2", max_inflight=8,
                   query_timeout_ms=5000)
    assert srv._warmup.wait(60)
    with ServerThread(srv) as t:
        status, text0, hdrs = call(t.port, "GET", "/metrics")
        for body in (QUERY, {"user": "5", "num": 2}, {"nope": 1}):
            jcall(t.port, "POST", "/queries.json", body)
        jcall(t.port, "GET", "/reload")
        text1 = call(t.port, "GET", "/metrics")[1].decode()
    fams = _families(s, text1)
    before, after = _samples(s, text0.decode()), _samples(s, text1)
    delta = {k: v - before.get(k, 0.0) for k, v in after.items()
             if v != before.get(k, 0.0)}
    # the whole registry's families, by name and kind, for the
    # comparison up to the JAX-only list
    names = {m.name: type(m).__name__ for m in s.registry.metrics()
             if m.name.startswith(COMPARED_PREFIXES)}
    return status, hdrs["Content-Type"], fams, delta, names


def _in_fresh_process(script_name, side):
    """``script(side)`` in a new interpreter on the side's home: the
    registries are process-wide, and the families and moves a check of
    them reads must not depend on what earlier tests in this process
    registered, or on servers and threads they left running."""
    code = ("import base64, pickle, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import tests.test_torch_ops_surface as m\n"
            "out = getattr(m, sys.argv[1])(m.Side(sys.argv[2], sys.argv[3]))\n"
            "sys.stdout.write(base64.b64encode(pickle.dumps(out)).decode())\n")
    proc = subprocess.run([sys.executable, "-c", code, script_name, side.name,
                           side.home], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return pickle.loads(base64.b64decode(proc.stdout.strip().splitlines()[-1]))


def test_metrics_families_and_deltas(trained):
    out = {s.name: _in_fresh_process("_metrics_script", s) for s in trained}
    j, p = out["jax"], out["torch"]
    assert p[:2] == j[:2] == (200, "text/plain; version=0.0.4")
    served = {n for n in p[2] if n.startswith(("pio_engine_", "pio_aot_",
                                               "pio_predict_device_"))}
    assert served <= set(j[2]) and {n: j[2][n] for n in served} == \
        {n: p[2][n] for n in served}
    def counted(delta):
        # counters and histogram counts; wall-time gauges differ by nature
        return {k: v for k, v in delta.items()
                if k[0].startswith(("pio_engine_", "pio_predict_device_",
                                    "pio_aot_"))
                and not k[0].endswith("_seconds")}

    want = counted(j[3])
    assert counted(p[3]) == want
    assert want[("pio_engine_queries_total", (("status", "200"),))] == 2
    assert want[("pio_engine_queries_total", (("status", "400"),))] == 1
    assert want[("pio_engine_reloads_total", (("result", "ok"),))] == 1
    missing = set(j[4]) - set(p[4])
    assert missing <= JAX_ONLY_FAMILIES, missing - JAX_ONLY_FAMILIES
    assert {n: p[4][n] for n in p[4]} == {n: j[4][n] for n in p[4]}


def test_metrics_history_has_samples(trained):
    def script(s):
        srv = s.engine(scrape_interval=0.05)
        with ServerThread(srv) as t:
            jcall(t.port, "POST", "/queries.json", QUERY)
            wait_for(lambda: jcall(t.port, "GET",
                                   "/metrics/history?series=pio_engine_queries_total"
                                   "&window=5m")[1].get("series"))
            code, body, _ = jcall(
                t.port, "GET", "/metrics/history?series=pio_engine_queries_total"
                "&window=5m")
            bad = jcall(t.port, "GET", "/metrics/history?series=???")[0]
            names = jcall(t.port, "GET", "/metrics/history")
        assert all(len(v) >= 1 for v in body["series"].values())
        return code, keys(body), 'pio_engine_queries_total{status="200"}' in \
            body["series"], bad, names[0], "pio_engine_queries_total" in \
            names[1]["names"]

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (200, ["series", "windowSeconds"], True, 400, 400, True)


def test_traces_hold_the_query_spans(trained):
    def script(s):
        s.tracing.TRACER.configure(enabled=True)
        srv = s.engine()
        with ServerThread(srv) as t:
            code, _, hdrs = jcall(t.port, "POST", "/queries.json", QUERY)
            tid = hdrs["X-PIO-Trace-Id"]
            spans = jcall(t.port, "GET", f"/traces?trace_id={tid}")[1]["spans"]
            bad = [jcall(t.port, "GET", f"/traces?{q}")[0]
                   for q in ("min_ms=x", "limit=y")]
            clamped = jcall(t.port, "GET", "/traces?limit=0")[1]["count"]
            errs = jcall(t.port, "GET", "/traces?error=1")[1]
        s.tracing.TRACER.reset()
        by_id = {d["spanId"]: d for d in spans}
        tree = sorted((d["name"], by_id.get(d["parentId"], {}).get("name"))
                      for d in spans)
        query = [d for d in spans if d["name"] == "engine.query"][0]
        return (code, tree, sorted(query["attrs"]), bad, clamped,
                keys(errs), errs["count"])

    out = both(trained, script)
    assert_same(out)
    assert ("engine.query", "http.request") in out["torch"][1]
    assert ("serving.device", "engine.predict") in out["torch"][1]
    assert out["torch"][3:5] == ([400, 400], 1)


def test_batched_dispatch_joins_its_first_querys_trace(trained):
    """The port's batcher dispatches in its first query's context, under
    a serving.batch span that names the batch's size and links the trace
    of every query it serves; the device span is its child. The JAX
    package's batcher dispatches outside any trace."""
    def script(s):
        s.tracing.TRACER.configure(enabled=True)
        srv = s.engine(batching=True, aot_buckets="1,2")
        assert srv._warmup.wait(60)
        with ServerThread(srv) as t:
            code, _, hdrs = jcall(t.port, "POST", "/queries.json", QUERY)
            tid = hdrs["X-PIO-Trace-Id"]
            spans = jcall(t.port, "GET", f"/traces?trace_id={tid}")[1]["spans"]
        s.tracing.TRACER.reset()
        by_id = {d["spanId"]: d["name"] for d in spans}
        batch = [d["attrs"] for d in spans if d["name"] == "serving.batch"]
        return (code, sorted((d["name"], by_id.get(d["parentId"])) for d in spans),
                [(a["size"], a["link_traces"] == [tid]) for a in batch])

    out = both(trained, script)
    assert out["jax"] == (200, [("engine.query", "http.request"),
                                ("http.request", None)], [])
    assert out["torch"] == (200, [("engine.query", "http.request"),
                                  ("http.request", None),
                                  ("serving.batch", "engine.query"),
                                  ("serving.device", "serving.batch")],
                            [(1, True)])


def test_batch_span_links_every_query_it_serves():
    """Six queries in one dispatch: one serving.batch span, under the
    first query's span, of size 6, linking all six traces in order."""
    import asyncio

    from predictionio_tpu_torch.server.batching import MicroBatcher

    tr = port_tracing
    tr.TRACER.reset()
    tr.TRACER.configure(enabled=True)
    batcher = MicroBatcher(lambda qs: [q * 2 for q in qs], max_batch=8,
                           max_wait_ms=50)

    async def one(q):
        async with tr.span("query") as sp:
            return await batcher.submit(q), sp.trace_id, sp.span_id

    async def main():
        try:
            return await asyncio.gather(*(one(q) for q in range(6)))
        finally:
            batcher.stop()

    try:
        got = asyncio.run(main())
        spans = tr.TRACER.ring.spans(limit=100)
    finally:
        tr.TRACER.reset()
    assert [r for r, _, _ in got] == [0, 2, 4, 6, 8, 10]
    (batch,) = [d for d in spans if d["name"] == "serving.batch"]
    assert batch["attrs"] == {"size": 6, "link_traces": [t for _, t, _ in got]}
    assert (batch["traceId"], batch["parentId"]) == got[0][1:]


def test_disabled_tracing_adds_no_spans_or_headers(trained):
    def script(s):
        with ServerThread(s.engine()) as t:
            _, _, hdrs = jcall(t.port, "GET", "/")
            body = jcall(t.port, "GET", "/traces")[1]
        return hdrs.get("X-PIO-Trace-Id"), body

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == (None, {"enabled": False, "count": 0, "spans": []})


def test_access_log_lines_have_the_same_fields(trained, caplog):
    def script(s):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="pio.access"):
            with ServerThread(s.engine(access_log=True)) as t:
                jcall(t.port, "POST", "/queries.json", QUERY)
                jcall(t.port, "GET", "/health")
                wait_for(lambda: len([r for r in caplog.records
                                      if r.name == "pio.access"]) >= 2)
        lines = [json.loads(r.getMessage()) for r in caplog.records
                 if r.name == "pio.access"]
        return [(sorted(d), d["method"], d["path"], d["status"]) for d in lines]

    out = both(trained, script)
    assert_same(out)
    assert [x[1:] for x in out["torch"]] == [("POST", "/queries.json", 200),
                                            ("GET", "/health", 200)]


# -- TLS -----------------------------------------------------------------------


@pytest.fixture()
def cert(tmp_path):
    cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    r = subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                        "-nodes", "-keyout", key, "-out", cert, "-days", "1",
                        "-subj", "/CN=localhost"], capture_output=True)
    if r.returncode != 0:
        pytest.skip("openssl unavailable")
    return cert, key


def _client():
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def test_tls_on_both_servers_from_env(trained, cert, monkeypatch):
    monkeypatch.setenv("PIO_SSL_CERT_PATH", cert[0])
    monkeypatch.setenv("PIO_SSL_KEY_PATH", cert[1])

    def script(s):
        out = []
        for srv in (s.engine(), s.Events(storage=s.storage, host="127.0.0.1",
                                         port=0)):
            assert srv.http.ssl_context is not None
            with ServerThread(srv) as t:
                out.append(jcall(t.port, "GET", "/health",
                                 context=_client())[:2][0])
                out.append(jcall(t.port, "GET", "/", context=_client())[0])
                with pytest.raises((ssl.SSLError, ConnectionError,
                                    http.client.HTTPException, OSError)):
                    call(t.port, "GET", "/", timeout=5)
        return out

    out = both(trained, script)
    assert_same(out)
    assert out["torch"] == [200, 200, 200, 200]


def test_ssl_context_from_env_contract(monkeypatch, cert):
    for fn in (ssl_context_from_env, jax_ssl):
        monkeypatch.delenv("PIO_SSL_CERT_PATH", raising=False)
        monkeypatch.delenv("PIO_SSL_KEY_PATH", raising=False)
        assert fn() is None
        monkeypatch.setenv("PIO_SSL_CERT_PATH", cert[0])
        with pytest.raises(ValueError):
            fn()
        assert isinstance(fn(cert_path=cert[0], key_path=cert[1]),
                          ssl.SSLContext)


# -- the event server ----------------------------------------------------------


def _event_app(s):
    app = s.storage.meta.create_app("OpsApp")
    s.storage.events.init_channel(app.id)
    return s.storage.meta.create_access_key(app.id, key="opsKey1").key


@pytest.mark.parametrize("batching", [False, True])
def test_event_server_health_metrics_traces(sides, batching):
    def script(s):
        key = _event_app(s)
        s.tracing.TRACER.configure(enabled=True)
        srv = s.Events(storage=s.storage, host="127.0.0.1", port=0,
                       ingest_batching=batching, scrape_interval=0.05)
        ev = {"event": "rate", "entityType": "user", "entityId": "u1",
              "targetEntityType": "item", "targetEntityId": "i1",
              "properties": {"rating": 4}}
        with ServerThread(srv) as t:
            text0 = call(t.port, "GET", "/metrics")[1].decode()
            posted = jcall(t.port, "POST", f"/events.json?accessKey={key}", ev)
            tid = posted[2]["X-PIO-Trace-Id"]
            health = jcall(t.port, "GET", "/health")
            if batching:
                for _ in range(srv._ingest.breaker.failure_threshold):
                    srv._ingest.breaker.record_failure()
                degraded = jcall(t.port, "GET", "/health")[1]
                srv._ingest.breaker.reset()
            else:
                degraded = {}
            status, text, _ = call(t.port, "GET", "/metrics")
            wait_for(lambda: jcall(t.port, "GET",
                                   "/metrics/history?series=pio_events_ingested_total"
                                   )[1].get("series"))
            spans = jcall(t.port, "GET", f"/traces?trace_id={tid}")[1]["spans"]
            commit = [d for d in jcall(t.port, "GET", "/traces")[1]["spans"]
                      if d["name"] == "ingest.commit"]
        s.tracing.TRACER.reset()
        # the families this script moved: which ones a process has
        # registered depends on the servers earlier tests built in it
        before, after = _samples(s, text0), _samples(s, text.decode())
        moved = {name for (name, labels), v in after.items()
                 if v != before.get((name, labels), 0.0)}
        body = {k: v for k, v in health[1].items() if k != "tenantQuotas"}
        return (posted[0], health[0], body, degraded.get("status"),
                degraded.get("reason"), status,
                sorted(n for n in moved if n.startswith(("pio_events_",
                                                         "pio_ingest_"))),
                sorted(d["name"] for d in spans),
                [tid in d["attrs"]["link_traces"] for d in commit])

    out = both(sides, script)
    assert_same(out)
    assert out["torch"][:2] == (201, 200)
    if batching:
        assert out["torch"][2]["ingest"]["breaker"] == "closed"
        assert out["torch"][3:5] == ("degraded",
                                     "ingest storage circuit breaker open")
        assert "ingest.submit" in out["torch"][7] and out["torch"][8] == [True]
    else:
        assert out["torch"][2] == {"status": "ok"}
        assert "storage.insert" in out["torch"][7]


def test_event_health_reports_tenant_quotas_only_in_the_jax_server(sides):
    """``tenantQuotas`` (the policy file's path) was the one /health key
    the port's event server lacked; since its ingest quotas are ported,
    both servers report it, each with its own home's file."""
    out = {}
    for s in sides:
        with ServerThread(s.Events(storage=s.storage, host="127.0.0.1",
                                   port=0)) as t:
            out[s.name] = jcall(t.port, "GET", "/health")[1]
    assert set(out["jax"]) == set(out["torch"]) == {"status", "tenantQuotas"}
    for s in sides:
        assert out[s.name]["tenantQuotas"] == os.path.join(s.home, "quotas.json")


# -- registry generation, device rule, CLI --------------------------------------


def test_registry_generation_lookup_matches_the_jax_registry(trained):
    jax_side, port_side = trained
    # a fresh home: both answer None; the port creates nothing
    fresh = str(jax_side.home) + "_fresh"
    os.makedirs(fresh)
    assert find_gen(fresh, port_side.first) is None
    assert os.listdir(fresh) == []
    assert jax_model_registry(JaxStorage(JaxStorageConfig(home=fresh))) \
        .find_gen(port_side.first) is None
    # the JAX registry's manifest, read by the port
    reg = jax_model_registry(JaxStorage(JaxStorageConfig(home=port_side.home)))
    blob = port_side.storage.models.get(port_side.first)
    gen = reg.register(port_side.first, blob)
    assert find_gen(port_side.home, port_side.first) == \
        reg.find_gen(port_side.first) == gen
    assert find_gen(port_side.home, "no-such-instance") is None
    srv = port_side.engine()
    with ServerThread(srv) as t:
        assert jcall(t.port, "GET", "/health")[1]["modelGeneration"] == gen


def test_no_card_and_no_cpu_request_raises_even_without_an_engine(
        sides, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineServer(engine_factory=FACTORY, storage=sides[1].storage, port=0,
                     require_engine=False)


def test_cli_flags_build_the_servers(trained, tmp_path, monkeypatch):
    s = trained[1]
    quotas = str(tmp_path / "q.json")
    args = cli.build_parser().parse_args([
        "deploy", "--engine-dir", ENGINE_DIR, "--ip", "127.0.0.1", "--port",
        "0", "--query-timeout-ms", "250", "--max-inflight", "7",
        "--tenant-quotas", quotas, "--access-log", "--tracing",
        "--trace-sample", "0.5", "--slow-query-ms", "40", "--trace-file",
        str(tmp_path / "spans.jsonl"), "--device", "cpu"])
    port_registry.set_storage(s.storage)
    try:
        srv = cli.make_server(args)
    finally:
        port_registry.set_storage(None)
    assert srv.query_timeout == 0.25 and srv.max_inflight == 7
    assert srv.quotas.path == quotas and srv.http.access_log
    assert srv.device.type == "cpu"
    try:
        cli._configure_tracing(args)
        tr = port_tracing.TRACER
        assert tr.enabled and tr.sample_rate == 0.5 and tr.slow_query_ms == 40
        assert tr.exporters[0].path == str(tmp_path / "spans.jsonl")
    finally:
        port_tracing.TRACER.reset()
    es_args = cli.build_parser().parse_args([
        "eventserver", "--port", "0", "--access-log", "--tracing",
        "--trace-file", ""])
    port_registry.set_storage(s.storage)
    try:
        es = cli.make_event_server(es_args)
        cli._configure_tracing(es_args)
        assert port_tracing.TRACER.enabled and not port_tracing.TRACER.exporters
    finally:
        port_registry.set_storage(None)
        port_tracing.TRACER.reset()
    assert es.http.access_log
    plain = cli.build_parser().parse_args(["deploy"])
    assert (plain.query_timeout_ms, plain.max_inflight, plain.tracing,
            plain.access_log, plain.tenant_quotas) == (0.0, 0, False, False, None)
