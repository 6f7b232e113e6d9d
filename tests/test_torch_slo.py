"""The port's SLO burn-rate engine held against the JAX package's, on the
CPU: the same TSDB samples through both packages' ``SloEngine`` give
equal statuses and gauges (availability, the multi-window page, empty
windows, counter resets, latency bucket snapping), the same refusals of
bad specs, ``conf/slo.json`` read alike; then the router's observability
plane on both packages over stub replicas (the fast-burn drill with
``slo.probe.fail``, the tagged probe, federation and ``/top``), driven by
the router's own ticks, and the port's ``slo status`` and ``top`` verbs,
whose exit codes are the JAX CLI's.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from predictionio_tpu.server import slo as jax_slo
from predictionio_tpu.utils import metrics as jax_metrics
from predictionio_tpu.utils import timeseries as jax_ts
from predictionio_tpu_torch.server import slo as port_slo
from predictionio_tpu_torch.utils import metrics as port_metrics
from predictionio_tpu_torch.utils import timeseries as port_ts
from tests.test_servers import ServerThread, free_port
from tests.test_torch_router import (
    PKG,
    StubReplica,
    cval,
    fleet,
    http_full,
    http_text,
    on_loop,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jax_slo, jax_metrics, jax_ts), "port": (port_slo, port_metrics, port_ts)}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def disarm_faults():
    for p in PKG.values():
        p.faults.disarm()
    yield
    for p in PKG.values():
        p.faults.disarm()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def make_store(pkg):
    _, metrics, ts = SIDES[pkg]
    return ts.TimeSeriesStore(metrics.Registry(), tiers=((1.0, 1000),), clock=FakeClock())


WINDOWS = {"windows": {"fast": ["10s", "60s"], "slow": ["60s"]}}


def avail_config(objective=0.99):
    return {**WINDOWS, "slos": [
        {"name": "avail", "type": "availability", "objective": objective,
         "series": "pio_p_total", "bad": {"outcome": "error"}}]}


def lat_config(threshold_ms):
    return {**WINDOWS, "slos": [
        {"name": "lat", "type": "latency", "objective": 0.9,
         "histogram": "pio_l_seconds", "threshold_ms": threshold_ms}]}


def _avail_burst(store):
    for outcome in ("ok", "error"):
        store.record("pio_p_total", {"outcome": outcome}, 0.0, ts=0.0)
    store.record("pio_p_total", {"outcome": "ok"}, 5.0, ts=10.0)
    store.record("pio_p_total", {"outcome": "error"}, 5.0, ts=10.0)
    return 10.0


def _old_burst(store):
    store.record("pio_p_total", {"outcome": "error"}, 0.0, ts=0.0)
    store.record("pio_p_total", {"outcome": "error"}, 10.0, ts=5.0)
    store.record("pio_p_total", {"outcome": "ok"}, 0.0, ts=0.0)
    for ts in (10.0, 20.0, 30.0, 40.0, 50.0, 58.0):
        store.record("pio_p_total", {"outcome": "error"}, 10.0, ts=ts)
        store.record("pio_p_total", {"outcome": "ok"}, ts, ts=ts)
    return 58.0


def _nothing(store):
    return 100.0


def _reset(store):
    for ts, ok, err in [(0, 100.0, 4.0), (10, 150.0, 4.0), (20, 10.0, 0.0), (30, 60.0, 0.0)]:
        store.record("pio_p_total", {"outcome": "ok"}, ok, ts=float(ts))
        store.record("pio_p_total", {"outcome": "error"}, err, ts=float(ts))
    return 30.0


def _latency(store):
    zero = {"0.1": 0.0, "0.25": 0.0, "0.5": 0.0, "+Inf": 0.0}
    after = {"0.1": 2.0, "0.25": 6.0, "0.5": 9.0, "+Inf": 10.0}
    for ts, counts in ((0.0, zero), (10.0, after)):
        for le, v in counts.items():
            store.record("pio_l_seconds_bucket", {"le": le}, v, ts=ts)
        store.record("pio_l_seconds_count", {}, counts["+Inf"], ts=ts)
    return 10.0


def _latency_blind(store):
    for ts, inf in ((0.0, 0.0), (10.0, 10.0)):
        store.record("pio_l_seconds_bucket", {"le": "0.5"}, 0.0, ts=ts)
        store.record("pio_l_seconds_bucket", {"le": "+Inf"}, inf, ts=ts)
        store.record("pio_l_seconds_count", {}, inf, ts=ts)
    return 10.0


#: (samples, config, the burn per window, the alerting level)
CASES = {
    "availability": (_avail_burst, avail_config(), {"10s": 50.0, "60s": 50.0}, 2),
    "multi_window": (_old_burst, avail_config(), None, 1),
    "no_events": (_nothing, avail_config(), {"10s": 0.0, "60s": 0.0}, 0),
    "counter_reset": (_reset, avail_config(), None, 0),
    "latency_snap": (_latency, lat_config(300), {"10s": 4.0, "60s": 4.0}, 0),
    "latency_blind": (_latency_blind, lat_config(1), {"10s": 0.0, "60s": 0.0}, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_burn_rates_equal_the_jax_engines(case):
    """One sample script into both packages' stores: the same burn per
    window, the same fast/slow verdicts and ``to_json``, the same gauges."""
    samples, cfg, burn, alerting = CASES[case]
    out = {}
    for pkg in ("jax", "port"):
        slo, metrics, _ = SIDES[pkg]
        store = make_store(pkg)
        ts = samples(store)
        eng = slo.SloEngine(store, cfg, registry=metrics.Registry())
        (st,) = eng.evaluate(ts=ts)
        out[pkg] = (st, eng)
    (js, je), (ps, pe) = out["jax"], out["port"]
    assert ps.burn == pytest.approx(js.burn, rel=0, abs=0)
    assert (ps.fast_burn, ps.slow_burn, ps.alerting) == (js.fast_burn, js.slow_burn,
                                                         js.alerting)
    assert ps.alerting == alerting
    if burn is not None:
        assert ps.burn == pytest.approx(burn)
    assert pe.to_json() == je.to_json()
    assert pe.fast_burning() == je.fast_burning()
    name = cfg["slos"][0]["name"]
    for w in ("10s", "60s"):
        assert pe._m_burn.get((name, w)) == je._m_burn.get((name, w))
    assert pe._m_alerting.get((name,)) == je._m_alerting.get((name,))


def test_multi_window_page_needs_every_fast_window():
    """The old burst still inside the long window pages neither package
    once the short window is clean: a slow burn, not a fast one."""
    for pkg in ("jax", "port"):
        slo, metrics, _ = SIDES[pkg]
        store = make_store(pkg)
        eng = slo.SloEngine(store, avail_config(), registry=metrics.Registry())
        (st,) = eng.evaluate(ts=_old_burst(store))
        assert st.burn["10s"] == pytest.approx(0.0) and st.burn["60s"] > 6.0
        assert not st.fast_burn and st.slow_burn and st.alerting == 1


def test_newly_fast_burning_is_a_rising_edge():
    for pkg in ("jax", "port"):
        slo, metrics, _ = SIDES[pkg]
        store = make_store(pkg)
        ts = _avail_burst(store)
        eng = slo.SloEngine(store, avail_config(), registry=metrics.Registry())
        eng.evaluate(ts=ts)
        assert eng.newly_fast_burning == ["avail"]
        eng.evaluate(ts=ts)
        assert eng.newly_fast_burning == []


@pytest.mark.parametrize("doc", [
    {"type": "availability"},
    {"name": "x", "type": "nope"},
    {"name": "x", "type": "availability", "objective": 1.5, "series": "s",
     "bad": {"o": "e"}},
    {"name": "x", "type": "availability", "objective": 0.9},
    {"name": "x", "type": "latency", "objective": 0.9, "histogram": "h"},
])
def test_bad_specs_are_refused_alike(doc):
    msgs = []
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError) as e:
            SIDES[pkg][0]._parse_spec(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@BOTH
def test_repo_slo_json_matches_builtin_default(pkg):
    slo, metrics, _ = SIDES[pkg]
    eng = slo.SloEngine.from_file(os.path.join(REPO, "conf", "slo.json"),
                                  make_store(pkg), registry=metrics.Registry())
    assert [s.name for s in eng.specs] == [d["name"] for d in slo.DEFAULT_CONFIG["slos"]]
    assert eng.fast_threshold == 14.4 and eng.slow_threshold == 6.0
    assert [w for w, _ in eng.fast_windows] == ["5m", "1h"]
    assert {s.series or s.histogram for s in slo.SloEngine(
        make_store(pkg), registry=metrics.Registry()).specs} == {
        "pio_probe_requests_total", "pio_probe_seconds"}


def test_default_configs_are_equal():
    assert port_slo.DEFAULT_CONFIG == jax_slo.DEFAULT_CONFIG
    assert port_slo.DEFAULT_WINDOWS == jax_slo.DEFAULT_WINDOWS
    assert port_slo.DEFAULT_THRESHOLDS == jax_slo.DEFAULT_THRESHOLDS


# -- the router's observability plane on both packages -------------------------------


def slo_cfg(tmp_path, fast=("300ms", "600ms"), slow=("2s",)):
    cfg = {"windows": {"fast": list(fast), "slow": list(slow)},
           "slos": [{"name": "probe-avail", "type": "availability",
                     "objective": 0.99, "series": "pio_probe_requests_total",
                     "labels": {"path": "/queries.json"},
                     "bad": {"outcome": "error"}}]}
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def ticked_router_kwargs(cfg_path):
    """No prober loop, and health polls and scrapes far apart: the cases
    send the canaries and tick (``_tick``)."""
    return {"hedge": False, "slo_config": cfg_path, "health_interval": 30.0,
            "scrape_interval": 3600.0, "probe_interval": 0.0}


#: the history's resolution for ticked routers (set before the first
#: sample: the scrape interval would set it otherwise)
FINE_TIERS = ((0.05, 7200), (120.0, 720))


def _tick(router, rt, probes=3):
    """``probes`` canaries, then one scrape and observe tick in a history
    slot of their own (a ring keeps the last write of a 50 ms slot)."""
    router.tsdb.tiers = FINE_TIERS
    for _ in range(probes):
        on_loop(rt, router._probe_once())
    time.sleep(0.06)
    router.tsdb.scrape()
    on_loop(rt, router._observe_tick())


@BOTH
def test_fast_burn_drill_trips_and_clears(pkg, tmp_path):
    """Armed ``slo.probe.fail``: a fast burn within the windows, /health
    degraded (still 200), the alerting gauge on /metrics; disarmed, the
    short windows clear the page."""
    with fleet(pkg, 1, ticked_router_kwargs(slo_cfg(tmp_path))) as (router, stubs, _, rt):
        base = f"http://127.0.0.1:{router.http.port}"
        _tick(router, rt)
        assert stubs[0].queries == 3
        code, doc, _ = http_full("GET", f"{base}/slo/status")
        assert code == 200 and doc["fastBurning"] == []
        assert doc["windows"]["fast"] == ["300ms", "600ms"]
        PKG[pkg].faults.arm("slo.probe.fail", error="drill")
        # a new series' first sample is its baseline: two ticks of failures
        _tick(router, rt)
        _tick(router, rt)
        assert stubs[0].queries == 3            # the failed canaries never left
        code, doc, _ = http_full("GET", f"{base}/slo/status")
        assert doc["fastBurning"] == ["probe-avail"]
        code, h, _ = http_full("GET", f"{base}/health")
        assert code == 200 and h["status"] == "degraded"
        assert h["sloFastBurn"] == ["probe-avail"]
        text = http_text(f"{base}/metrics")
        assert 'pio_slo_alerting{slo="probe-avail"} 2' in text
        assert "pio_slo_burn_rate" in text
        PKG[pkg].faults.disarm()
        time.sleep(0.7)                         # past both fast windows
        _tick(router, rt)
        code, doc, _ = http_full("GET", f"{base}/slo/status")
        assert doc["fastBurning"] == []
        code, h, _ = http_full("GET", f"{base}/health")
        assert code == 200 and h["status"] == "ok"


@BOTH
def test_probe_is_tagged_and_counted(pkg, tmp_path):
    with fleet(pkg, 1, ticked_router_kwargs(slo_cfg(tmp_path))) as (router, stubs, _, rt):
        ok0 = cval(router._m_probe, "/queries.json", "ok")
        _tick(router, rt, probes=2)
        assert cval(router._m_probe, "/queries.json", "ok") == ok0 + 2
        assert stubs[0].queries == 2
        base = f"http://127.0.0.1:{router.http.port}"
        code, doc, _ = http_full(
            "GET", f"{base}/metrics/history?series=pio_probe_requests_total&window=10s")
        assert code == 200
        assert any('outcome="ok"' in k for k in doc["series"])


@BOTH
def test_federation_and_top(pkg, tmp_path):
    kwargs = ticked_router_kwargs(slo_cfg(tmp_path))
    p = PKG[pkg]
    stubs = [StubReplica(p, free_port(), instance=f"m-{i}") for i in range(2)]
    import contextlib

    with contextlib.ExitStack() as stack:
        for s in stubs:
            stack.enter_context(ServerThread(s))
        router = p.router.FleetRouter([s.url for s in stubs], host="127.0.0.1",
                                      port=free_port(), **kwargs)
        rt = stack.enter_context(ServerThread(router))
        base = f"http://127.0.0.1:{router.http.port}"
        _tick(router, rt)
        text = http_text(f"{base}/metrics")
        assert 'pio_fleet_engine_queries_total{status="200"} 10' in text
        assert "pio_build_info" in text
        for s in stubs:
            assert cval(router._m_federate, s.url, "ok") >= 1
        code, doc, _ = http_full(
            "GET", f"{base}/metrics/history?series=pio_fleet_engine_queries_total&window=10s")
        assert code == 200 and doc["series"]
        code, doc, _ = http_full("GET", f"{base}/metrics/history")
        assert code == 400 and "pio_fleet_engine_queries_total" in doc["names"]
        code, top, _ = http_full("GET", f"{base}/top?window=10s")
        assert code == 200 and top["qps"]["total"] >= 0
        assert len(top["replicas"]) == 2
        assert top["slo"]["slos"][0]["name"] == "probe-avail"
        assert http_full("GET", f"{base}/top?window=bogus")[0] == 400


def _cli(pkg, *args):
    module = ("predictionio_tpu.tools.cli" if pkg == "jax"
              else "predictionio_tpu_torch.tools.cli")
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_slo_status_and_top_verbs_match_the_jax_cli(tmp_path):
    """``slo status`` (table and ``--json``) and ``top --once [--json]``
    of both CLIs against one port router: the same exit codes (0 quiet,
    1 fast-burning), the same table lines, the same JSON keys. The
    windows outlast the CLIs' start-up, so the burn holds while both
    verbs read it."""
    cfg = slo_cfg(tmp_path, fast=("30s", "60s"), slow=("120s",))
    with fleet("port", 1, ticked_router_kwargs(cfg)) as (
            router, stubs, _, rt):
        base = f"http://127.0.0.1:{router.http.port}"
        _tick(router, rt)
        runs = {pkg: {name: _cli(pkg, *args) for name, args in (
            ("slo", ("slo", "status", "--url", base)),
            ("slo_json", ("slo", "status", "--url", base, "--json")),
            ("top_json", ("top", "--url", base, "--once", "--json")),
            ("top", ("top", "--url", base, "--once")))}
            for pkg in ("jax", "port")}
        for name in ("slo", "slo_json", "top_json", "top"):
            assert runs["port"][name].returncode == runs["jax"][name].returncode == 0, (
                runs["port"][name].stderr)
        assert runs["port"]["slo"].stdout == runs["jax"]["slo"].stdout
        assert "probe-avail" in runs["port"]["slo"].stdout
        assert sorted(json.loads(runs["port"]["slo_json"].stdout)) == sorted(
            json.loads(runs["jax"]["slo_json"].stdout))
        assert sorted(json.loads(runs["port"]["top_json"].stdout)) == sorted(
            json.loads(runs["jax"]["top_json"].stdout))
        assert runs["port"]["top"].stdout.splitlines()[0].startswith("pio top")
        assert "REPLICA" in runs["port"]["top"].stdout

        PKG["port"].faults.arm("slo.probe.fail", error="drill")
        _tick(router, rt)
        _tick(router, rt)
        burning = {pkg: _cli(pkg, "slo", "status", "--url", base) for pkg in ("jax", "port")}
        assert burning["port"].returncode == burning["jax"].returncode == 1
        assert "FAST BURN" in burning["port"].stdout
        assert burning["port"].stdout == burning["jax"].stdout
    # a router that is gone: both verbs die with 1 and a readable line
    gone = {pkg: _cli(pkg, "slo", "status", "--url", base, "--timeout", "2")
            for pkg in ("jax", "port")}
    assert gone["port"].returncode == gone["jax"].returncode == 1
    assert "[error] GET" in gone["port"].stderr


def test_port_ops_verbs_import_no_torch():
    code = ("import sys\n"
            "from predictionio_tpu_torch.tools import cli\n"
            "for argv in (['slo', 'status', '--help'], ['top', '--help'],\n"
            "             ['doctor', '--help']):\n"
            "    try:\n"
            "        cli.main(argv)\n"
            "    except SystemExit:\n"
            "        pass\n"
            "import predictionio_tpu_torch.server.slo, predictionio_tpu_torch.server.router\n"
            "import predictionio_tpu_torch.server.remediate\n"
            "print(sorted(m for m in sys.modules if m in ('torch', 'numpy', 'jax')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
