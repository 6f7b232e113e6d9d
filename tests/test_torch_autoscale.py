"""The port's autoscaler, remediation engine and self-healing loop held
against the JAX package's, on the CPU: every decision case of
``tests/test_autoscale.py`` on both packages with an injected clock (the
same decision log, reasons and pool sizes), the remediation engine's
plans, dry runs, target verification, rate limits, dedup, storm guard
and fenced lock on both, the playbook files read alike, ``RouterActuator``
and ``OpsActuator`` against a live port router over a port
``ReplicaPool`` of stub replicas, and the self-healing smoke: the port
router, its pool and its auto-remediator with ``router.replica.down``
armed fire exactly one restart.
"""

import json
import os

import pytest

from predictionio_tpu.server import autoscale as jax_autoscale
from predictionio_tpu.server import remediate as jax_remediate
from predictionio_tpu_torch.server import autoscale as port_autoscale
from predictionio_tpu_torch.server import remediate as port_remediate
from predictionio_tpu_torch.server.router import FleetRouter
from predictionio_tpu_torch.tools.supervise import ReplicaPool
from tests.test_autoscale import (
    STUB_SPAWN,
    Clock,
    FakeActuator,
    FakePool,
    FakeRouter,
    _findings,
)
from tests.test_servers import ServerThread, free_port
from tests.test_torch_router import PKG, http_full, on_loop, wait_until

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jax_autoscale, jax_remediate), "port": (port_autoscale, port_remediate)}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def disarm_faults():
    for p in PKG.values():
        p.faults.disarm()
    yield
    for p in PKG.values():
        p.faults.disarm()


def _scaler(pkg, n=1, **cfg_kw):
    autoscale = SIDES[pkg][0]
    cfg_kw.setdefault("sustain_ticks", 3)
    cfg_kw.setdefault("quiet_ticks", 2)
    cfg_kw.setdefault("cooldown_up", 10.0)
    cfg_kw.setdefault("cooldown_down", 60.0)
    router = FakeRouter(n)
    pool = FakePool(router)
    clk = Clock()
    a = autoscale.Autoscaler(router, pool, autoscale.AutoscaleConfig(**cfg_kw), clock=clk)
    return a, router, pool, clk


def _step(a):
    decision = a.tick()
    a.act(decision)
    return decision


def _script_sustained(pkg):
    a, router, pool, _ = _scaler(pkg, n=1)
    router.tsdb.qps = 1000.0
    return [_step(a) for _ in range(3)], pool.size()


def _script_spike(pkg):
    a, router, pool, _ = _scaler(pkg, n=1)
    out = []
    for qps in (1000.0, 1000.0, 0.0, 1000.0):
        router.tsdb.qps = qps
        out.append(_step(a))
    return out, pool.size()


def _script_slo_burn(pkg):
    a, router, pool, _ = _scaler(pkg, n=1, sustain_ticks=1)
    router.slo.burning = ["availability"]
    return [_step(a)], pool.size()


def _script_p99(pkg):
    a, router, pool, _ = _scaler(pkg, n=1, sustain_ticks=1)
    router.tsdb.qps, router.tsdb.p99 = 20.0, 0.9
    return [_step(a)], pool.size()


def _script_quiet(pkg):
    a, router, pool, clk = _scaler(pkg, n=3, quiet_ticks=2, cooldown_down=5.0)
    out = []
    for _ in range(3):
        out += [_step(a), _step(a)]
        clk.t += 10.0
    return out, pool.size()


def _script_last_healthy(pkg):
    a, router, pool, _ = _scaler(pkg, n=2, quiet_ticks=1)
    router.replicas[0].state = "down"
    return [_step(a)], pool.size()


def _script_cooldown(pkg):
    a, router, pool, clk = _scaler(pkg, n=1, sustain_ticks=1, cooldown_up=30.0)
    router.tsdb.qps = 1000.0
    out = [_step(a), _step(a)]
    clk.t += 31.0
    return out + [_step(a)], pool.size()


def _script_at_max(pkg):
    a, router, pool, _ = _scaler(pkg, n=4, sustain_ticks=1, max_replicas=4)
    router.tsdb.qps = 10_000.0
    return [_step(a)], pool.size()


def _script_flap(pkg):
    a, router, pool, clk = _scaler(pkg, n=2, sustain_ticks=1, quiet_ticks=1,
                                   cooldown_up=0.0, cooldown_down=0.0, flap_window=600.0,
                                   flap_max_actions=3)
    PKG[pkg].faults.arm("autoscale.flap", error="poisoned signal")
    out = []
    for i in range(12):
        router.tsdb.qps = 1000.0 if i % 2 == 0 else 0.0
        out.append(_step(a))
        clk.t += 1.0
    assert len(a._actions) <= 3
    return out, pool.size()


#: script, then (the actions and reasons, the pool size at the end)
SCRIPTS = {
    "sustained": (_script_sustained, ([("hold", "sustaining")] * 2 + [("up", "qps")], 2)),
    "spike": (_script_spike, (None, 1)),
    "slo_burn": (_script_slo_burn, ([("up", "slo-burn")], 2)),
    "p99": (_script_p99, ([("up", "p99")], 2)),
    "quiet": (_script_quiet, ([("hold", "sustaining"), ("down", "quiet")] * 2
                              + [("hold", "sustaining"), ("hold", "last-healthy")], 1)),
    "last_healthy": (_script_last_healthy, ([("hold", "last-healthy")], 2)),
    "cooldown": (_script_cooldown, ([("up", "qps"), ("hold", "cooldown"), ("up", "qps")], 3)),
    "at_max": (_script_at_max, ([("hold", "at-max")], 4)),
    "flap": (_script_flap, (None, None)),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_autoscaler_decides_as_the_jax_one(script):
    """One signal script through both packages' autoscalers, each over a
    fake router and pool with an injected clock: the same decisions
    (action, reason, signals, replica counts) tick by tick and the same
    pool size."""
    fn, (want, size) = SCRIPTS[script]
    out = {}
    for pkg in ("jax", "port"):
        for p in PKG.values():
            p.faults.disarm()
        decisions, final = fn(pkg)
        # "at" is the wall clock's stamp of the log entry
        out[pkg] = ([{k: v for k, v in d.items() if k != "at"} for d in decisions], final)
    assert out["port"] == out["jax"]
    decisions, final = out["port"]
    if want is not None:
        got = [(d["action"], d["reason"]) for d in decisions]
        if script == "quiet":
            assert [g for g in got if g[0] == "down"] == [("down", "quiet")] * 2
            assert got[-1] == ("hold", "last-healthy")
        else:
            assert got == want
    if size is not None:
        assert final == size


@BOTH
def test_decision_log_and_status_doc(pkg):
    a, router, _, _ = _scaler(pkg, n=1)
    _step(a)
    doc = a.status_doc()
    assert doc["config"]["maxReplicas"] == 4
    assert doc["decisions"][-1]["action"] == "hold"
    assert set(doc["decisions"][-1]["signals"]) >= {
        "replicas", "healthy", "qps", "p99_ms", "inflight"}


def test_status_docs_are_equal():
    docs = {}
    for pkg in ("jax", "port"):
        a, router, _, _ = _scaler(pkg, n=2)
        router.tsdb.qps = 30.0
        _step(a)
        _step(a)
        doc = a.status_doc()
        for d in doc["decisions"]:
            d.pop("at", None)
        docs[pkg] = doc
    assert docs["port"] == docs["jax"]


# -- the remediation engine ------------------------------------------------------------


def _engine(pkg, **kw):
    remediate = SIDES[pkg][1]
    act = FakeActuator()
    return remediate.RemediationEngine(act, remediate.load_playbooks(), **kw), act


def _strip(results):
    return [{k: v for k, v in r.items() if k not in ("ts", "at")} for r in results]


def test_plans_and_dry_runs_equal_the_jax_engines():
    out = {}
    for pkg in ("jax", "port"):
        eng, act = _engine(pkg)
        plan = eng.plan(_findings())
        out[pkg] = (plan, _strip(eng.execute(plan, yes=False)), act.calls)
    assert out["port"] == out["jax"]
    plan, results, calls = out["port"]
    assert {e["action"]: e["target"] for e in plan} == {
        "restart_replica": "127.0.0.1:8001", "clamp_tenant": "hog",
        "exclude_probe": "probe", "rollback_model": "champion"}
    assert all(r["result"] == "dry-run" for r in results) and calls == []


@BOTH
def test_yes_executes_through_verification(pkg):
    eng, act = _engine(pkg)
    results = eng.execute(eng.plan(_findings()), yes=True)
    assert {r["result"] for r in results} == {"executed"}
    assert ("restart_replica", "127.0.0.1:8001") in act.calls


@BOTH
def test_wrong_target_drill_is_refused(pkg):
    eng, act = _engine(pkg)
    PKG[pkg].faults.arm("remediate.wrong_target", error="drill")
    results = eng.execute(eng.plan(_findings()[:1]), yes=True)
    assert results[0]["result"].startswith("refused")
    assert results[0]["target"] == "healthy:9999"
    assert act.calls == []


@BOTH
def test_per_playbook_rate_limit(pkg):
    remediate = SIDES[pkg][1]
    clk = Clock()
    pb = remediate.Playbook(name="restart", action="restart_replica",
                            kinds=("breaker-open",), rate_max=2, rate_window=600.0)
    eng = remediate.RemediationEngine(FakeActuator(), [pb], clock=clk)
    for i, expected in [(1, "executed"), (2, "executed"), (3, "rate-limited")]:
        f = dict(_findings()[0], replica=f"http://127.0.0.1:800{i}")
        assert eng.execute(eng.plan([f]), yes=True)[0]["result"] == expected
    clk.t += 601.0
    f = dict(_findings()[0], replica="http://127.0.0.1:8009")
    assert eng.execute(eng.plan([f]), yes=True)[0]["result"] == "executed"


@BOTH
def test_auto_remediate_dedups_persistent_findings(pkg):
    eng, _ = _engine(pkg, clock=Clock())
    assert len(eng.auto_remediate(_findings()[:1])) == 1
    assert eng.auto_remediate(_findings()[:1]) == []


@BOTH
def test_storm_guard_holds_on_rate_limit(pkg):
    remediate = SIDES[pkg][1]
    clk = Clock()
    pb = remediate.Playbook(name="restart", action="restart_replica",
                            kinds=("breaker-open",), rate_max=1, rate_window=600.0)
    act = FakeActuator()
    eng = remediate.RemediationEngine(act, [pb], clock=clk)
    PKG[pkg].faults.arm("remediate.storm", error="storm drill")
    executed = 0
    for _ in range(6):
        executed += sum(1 for r in eng.auto_remediate(_findings()[:1])
                        if r["result"] == "executed")
        clk.t += 1.0
    assert executed == 1 and len(act.calls) == 1


@BOTH
def test_one_remediation_in_flight_lock(pkg, tmp_path):
    lock = str(tmp_path / "remediation.lock")
    eng, act = _engine(pkg, lock_path=lock)
    with open(lock, "w") as f:
        f.write("12345")
    assert eng.execute(eng.plan(_findings()[:1]), yes=True)[0]["result"] == "locked"
    assert act.calls == []
    os.unlink(lock)
    assert eng.execute(eng.plan(_findings()[:1]), yes=True)[0]["result"] == "executed"
    assert not os.path.exists(lock)


@BOTH
def test_load_playbooks_paths(pkg, tmp_path):
    remediate = SIDES[pkg][1]
    assert remediate.DEFAULT_PLAYBOOKS_PATH == os.path.join("conf", "remediations.json")
    names = {p.name for p in remediate.load_playbooks(
        os.path.join(REPO, "conf", "remediations.json"))}
    assert names == {p.name for p in remediate.load_playbooks()}
    with pytest.raises(OSError):
        remediate.load_playbooks(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text('{"playbooks": [{"name": "x", "action": "rm -rf"}]}')
    with pytest.raises(ValueError):
        remediate.load_playbooks(str(bad))


def test_playbooks_and_targets_equal_the_jax_ones():
    def rows(remediate):
        return [(p.name, p.action, tuple(p.kinds), p.rate_max, p.rate_window)
                for p in remediate.load_playbooks(
                    os.path.join(REPO, "conf", "remediations.json"))]

    assert rows(port_remediate) == rows(jax_remediate)
    assert port_remediate.DEFAULT_PLAYBOOKS_DOC == jax_remediate.DEFAULT_PLAYBOOKS_DOC
    for f, action in (({"replica": "http://10.0.0.1:8000/"}, "restart_replica"),
                      ({}, "restart_replica"), ({"app": "hog"}, "clamp_tenant"),
                      ({"generation": 7}, "rollback_model"), ({}, "exclude_probe")):
        assert (port_remediate.finding_target(f, action)
                == jax_remediate.finding_target(f, action))


def test_clamp_tenant_writes_the_jax_quota_file(tmp_path):
    """``clamp_tenant`` through each package's ``OpsActuator`` on twin
    homes: the same ``quotas.json``."""
    out = {}
    for pkg in ("jax", "port"):
        home = tmp_path / pkg
        home.mkdir()
        act = SIDES[pkg][1].OpsActuator(home=str(home))
        first = act.clamp_tenant("hog")
        act.clamp_tenant("hog", rateFactor=0.5)
        out[pkg] = (first, json.loads((home / "quotas.json").read_text()))
    assert out["port"] == out["jax"]
    assert out["port"][0] == "app hog ingest clamped 0 -> 100 events/s"


# -- the port's router, pool and remediator together -------------------------------------


def _port_pool(tmp_path, **kw):
    kw.setdefault("drain_grace", 0.05)
    kw.setdefault("ready_timeout", 30.0)
    kw.setdefault("backoff", 0.05)
    kw.setdefault("backoff_max", 0.1)
    kw.setdefault("log", lambda *a: None)
    return ReplicaPool(STUB_SPAWN, str(tmp_path / "manifest.txt"), **kw)


def test_router_pool_endpoints_and_actuators(tmp_path):
    """``/pool/status|add|remove|restart``, ``/autoscale/status`` and
    ``/probe`` of a port router over a port pool of stub replicas, the
    manifest rewrite reaching the routing table on the router's own
    tick, ``RouterActuator``'s verification and restart, and
    ``OpsActuator`` over HTTP."""
    pool = _port_pool(tmp_path)
    try:
        pool.add_replica()
        router = FleetRouter(
            manifest=str(tmp_path / "manifest.txt"), host="127.0.0.1", port=free_port(),
            hedge=False, health_interval=30.0, scrape_interval=3600.0, probe_interval=0.0,
            pool=pool, autoscale=port_autoscale.AutoscaleConfig(
                min_replicas=1, max_replicas=2, interval=3600.0))
        with ServerThread(router) as rt:
            base = f"http://127.0.0.1:{router.http.port}"
            code, doc, _ = http_full("GET", f"{base}/pool/status")
            assert code == 200 and doc["size"] == 1
            code, doc, _ = http_full("POST", f"{base}/pool/add", timeout=60)
            assert code == 200 and doc["ok"] is True
            added = doc["added"]
            on_loop(rt, router._poll_all())
            assert sorted(r.name for r in router.replicas) == pool.names()
            assert all(r.state == "ok" for r in router.replicas)
            code, doc, _ = http_full("GET", f"{base}/autoscale/status")
            assert code == 200 and doc["config"]["maxReplicas"] == 2
            # the actuators verify before acting: a healthy replica is refused
            ra = port_remediate.RouterActuator(router, pool)
            ok, why = ra.verify("restart_replica", added)
            assert not ok and "not wedged" in why
            ops = port_remediate.OpsActuator(url=base, home=str(tmp_path))
            ok, why = ops.verify("restart_replica", added)
            assert not ok and "not wedged" in why
            assert ops.verify("restart_replica", "127.0.0.1:1")[0] is False
            pid = pool.child_pid(added)
            assert ops.restart_replica(added) == f"router restarted {added}"
            assert wait_until(lambda: pool.child_pid(added) not in (None, pid), timeout=15)
            assert ops.exclude_probe("probe", resumeAfterSec=30) == "prober paused for 30s"
            assert router._probe_paused_until > 0
            code, doc, _ = http_full("POST", f"{base}/probe?resume=1")
            assert code == 200 and router._probe_paused_until == 0.0
            assert http_full("POST", f"{base}/pool/restart")[0] == 400
            code, doc, _ = http_full("POST", f"{base}/pool/remove?replica={added}",
                                     timeout=60)
            assert code == 200 and doc["removed"] == added
            assert http_full("POST", f"{base}/pool/remove", timeout=60)[0] == 409
            on_loop(rt, router._poll_all())
            assert [r.name for r in router.replicas] == pool.names()
    finally:
        pool.stop_all()


def test_routers_without_a_pool_answer_409_alike():
    codes = {}
    for pkg in ("jax", "port"):
        router = PKG[pkg].router.FleetRouter(["127.0.0.1:1"], host="127.0.0.1",
                                             port=free_port(), health_interval=30.0)
        with ServerThread(router):
            base = f"http://127.0.0.1:{router.http.port}"
            codes[pkg] = [http_full(m, f"{base}{p}")[0] for m, p in (
                ("GET", "/pool/status"), ("POST", "/pool/add"), ("POST", "/pool/remove"),
                ("POST", "/pool/restart?replica=x"), ("GET", "/autoscale/status"),
                ("POST", "/probe"))]
    assert codes["port"] == codes["jax"] == [409, 409, 409, 409, 409, 400]


@pytest.mark.chaos
def test_wedged_replica_remediated_exactly_once(tmp_path):
    """Two stub replicas in a port pool behind the port router with its
    remediation loop, ``router.replica.down`` armed so forwards fail
    while /health stays green: the breakers open, exactly one restart
    fires, the dedup and the rate limit hold the storm, and the fleet
    heals once the fault is disarmed."""
    remfile = tmp_path / "remediations.json"
    remfile.write_text(json.dumps({"playbooks": [
        {"name": "restart-wedged-replica",
         "match": {"kinds": ["replica-down", "breaker-open"], "minSeverity": 1},
         "action": "restart_replica", "rateLimit": {"max": 1, "windowSec": 600}}]}))
    pool = _port_pool(tmp_path)
    try:
        pool.add_replica()
        pool.add_replica()
        router = FleetRouter(
            manifest=str(tmp_path / "manifest.txt"), host="127.0.0.1", port=free_port(),
            health_interval=0.1, scrape_interval=0.2, probe_interval=0.0,
            incident_dir=str(tmp_path / "incidents"), pool=pool,
            autoscale=port_autoscale.AutoscaleConfig(min_replicas=2, max_replicas=2,
                                                     interval=0.2, window=5.0),
            remediations=str(remfile))
        eng = router.remediator

        def executed():
            return sum(1 for e in eng.log if e["result"] == "executed")

        with ServerThread(router):
            base = f"http://127.0.0.1:{router.http.port}"
            assert wait_until(lambda: all(r.state == "ok" for r in router.replicas),
                              timeout=15)
            PKG["port"].faults.arm("router.replica.down", error="wedged")
            for _ in range(12):
                http_full("POST", f"{base}/queries.json", {"user": "u", "num": 1},
                          timeout=10)
            assert wait_until(lambda: any(r.breaker.state == "open"
                                          for r in router.replicas), timeout=15)
            assert wait_until(lambda: executed() >= 1, timeout=15)
            # more control ticks: the dedup and the rate limit hold
            ticks = router.autoscaler.status_doc()["decisions"]
            n0 = len(ticks)
            assert wait_until(lambda: len(router.autoscaler.status_doc()["decisions"])
                              >= min(n0 + 5, 100), timeout=15)
            assert executed() == 1, f"remediation storm: {list(eng.log)}"
            assert all(e["result"] in ("executed", "rate-limited") for e in eng.log)
            PKG["port"].faults.disarm("router.replica.down")
            assert wait_until(lambda: all(r.state == "ok" for r in router.replicas),
                              timeout=20)
        # the remediation is on the incident timeline
        bundles = os.listdir(tmp_path / "incidents")
        assert bundles
    finally:
        pool.stop_all()
