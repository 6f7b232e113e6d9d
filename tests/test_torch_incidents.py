"""The incident flight recorder held against the JAX package's, on the CPU.

Each case of ``tests/test_incidents.py`` runs once on each package
(``pkg``): the store (ids, manifest last, listing, retention), the capture
helpers, the capturer (debounce, coalescing, sources, history, faults,
the ``incident.capture.stall`` drill, pruning), the crash hook and
``diagnose``/``diagnose_live``/``exit_code``. The crash hook is installed
and ``sys.excepthook`` restored inside each case. Then the packages
against each other: one capture on a fake clock gives equal bundle file
names, manifest keys and sources from both; ``diagnose`` gives equal
findings on one bundle either package wrote; ``incidents list|show|prune``
print the same lines on twin homes. The servers: an engine server whose
feedback sink is down and an event server whose group commit fails each
write one ``breaker-open`` bundle with the ``health`` source, and a
``KeyboardInterrupt`` (an operator's SIGINT) is not a crash in the port.
"""

import json
import os
import shutil
import sys
import types

import pytest

from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu.utils import incidents as jax_incidents
from predictionio_tpu.utils import metrics as jax_metrics
from predictionio_tpu.utils import timeseries as jax_timeseries
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.utils import faults as port_faults
from predictionio_tpu_torch.utils import incidents as port_incidents
from predictionio_tpu_torch.utils import metrics as port_metrics
from predictionio_tpu_torch.utils import timeseries as port_timeseries
from tests.test_torch_cli import Twins
from tests.test_torch_event_server import ServerThread
from tests.test_torch_feedback_plugins import FailingSink, trained_home  # noqa: F401
from tests.test_torch_ops_surface import jcall, wait_for
from tests.test_workflow import FACTORY

PACKAGES = {
    "jax": types.SimpleNamespace(
        incidents=jax_incidents, FAULTS=jax_faults.FAULTS,
        Registry=jax_metrics.Registry, TimeSeriesStore=jax_timeseries.TimeSeriesStore),
    "torch": types.SimpleNamespace(
        incidents=port_incidents, FAULTS=port_faults.FAULTS,
        Registry=port_metrics.Registry, TimeSeriesStore=port_timeseries.TimeSeriesStore),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_state():
    hook = sys.excepthook
    for p in PACKAGES.values():
        p.FAULTS.disarm()
    yield
    sys.excepthook = hook
    for p in PACKAGES.values():
        p.FAULTS.disarm()


class FakeClock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _captures(pkg, trigger, result):
    return dict(pkg.incidents._m_captures.items()).get((trigger, result), 0.0)


def _capturer(pkg, tmp_path, clk, **kw):
    store = pkg.incidents.IncidentStore(str(tmp_path), clock=clk)
    return store, pkg.incidents.IncidentCapturer(store, "test", clock=clk, **kw)


# -- the store (tests/test_incidents.py) ------------------------------------------


def test_default_dir(pkg):
    assert pkg.incidents.default_incident_dir("/x/home") == os.path.join("/x/home",
                                                                         "incidents")


def test_new_id_uniquifies_within_one_second(pkg, tmp_path):
    store = pkg.incidents.IncidentStore(str(tmp_path))
    seen = []
    for _ in range(3):
        iid = store.new_id(1_700_000_000.0, "crash")
        os.makedirs(store.path(iid))
        seen.append(iid)
    assert seen == ["20231114T221320-crash", "20231114T221320-crash-2",
                    "20231114T221320-crash-3"]


def test_write_bundle_manifest_last_and_files_list(pkg, tmp_path):
    store = pkg.incidents.IncidentStore(str(tmp_path))
    d = store.write_bundle("20240101T000000-test",
                           {"health.json": {"status": "ok"}, "note.txt": "plain text"},
                           {"trigger": "test"})
    assert sorted(os.listdir(d)) == ["health.json", "manifest.json", "note.txt"]
    m = store.load_manifest("20240101T000000-test")
    assert m["files"] == ["health.json", "manifest.json", "note.txt"]
    with open(os.path.join(d, "note.txt")) as f:
        assert f.read() == "plain text"
    assert store.read_json("20240101T000000-test", "health.json") == {"status": "ok"}
    assert store.load_bundle("20240101T000000-test")["files"] == {
        "health.json": {"status": "ok"}}


def test_ids_newest_first_and_incomplete_listing(pkg, tmp_path):
    store = pkg.incidents.IncidentStore(str(tmp_path))
    store.write_bundle("20240101T000000-a", {}, {"trigger": "a"})
    store.write_bundle("20240102T000000-b", {}, {"trigger": "b"})
    os.makedirs(store.path("20240103T000000-c"))
    assert store.ids() == ["20240103T000000-c", "20240102T000000-b",
                           "20240101T000000-a"]
    rows = store.list_bundles()
    assert rows[0] == {"id": "20240103T000000-c", "incomplete": True}
    assert rows[1]["trigger"] == "b"
    assert store.load_bundle("20240103T000000-c") is None


def test_prune_drops_oldest_beyond_retention(pkg, tmp_path):
    clk = FakeClock()
    store = pkg.incidents.IncidentStore(str(tmp_path), retain=3, clock=clk)
    ids = []
    for _ in range(5):
        iid = store.new_id(clk(), "slo-fast-burn")
        store.write_bundle(iid, {}, {"trigger": "slo-fast-burn"})
        ids.append(iid)
        clk.advance(1.0)
    assert store.prune() == [ids[1], ids[0]]
    assert store.ids() == [ids[4], ids[3], ids[2]]
    assert store.prune(retain=1) == [ids[3], ids[2]]
    assert store.ids() == [ids[4]]


def test_missing_root_is_empty_not_error(pkg, tmp_path):
    store = pkg.incidents.IncidentStore(str(tmp_path / "never-created"))
    assert store.ids() == [] and store.list_bundles() == [] and store.prune() == []


# -- capture helpers ----------------------------------------------------------------


def test_collect_exemplars_worst_first(pkg):
    reg = pkg.Registry()
    h = reg.histogram("pio_t_seconds", "t", buckets=[0.1, 1.0], labelnames=("path",))
    h.observe(0.05, ("a",), exemplar="trace-fast")
    h.observe(5.0, ("b",), exemplar="trace-slow")
    out = pkg.incidents.collect_exemplars(reg)
    assert [e["traceId"] for e in out] == ["trace-slow", "trace-fast"]
    assert out[0]["le"] == "+Inf" and out[0]["valueMs"] == 5000.0
    assert out[1]["labels"] == {"path": "a"}
    assert pkg.incidents.collect_exemplars(reg, limit=1) == out[:1]


def test_build_info_snapshot(pkg):
    reg = pkg.Registry()
    reg.gauge("pio_build_info", "b", ("version", "commit")).set(1.0, ("1.2.3", "abc123"))
    assert pkg.incidents.build_info_snapshot(reg) == {"version": "1.2.3",
                                                      "commit": "abc123"}
    assert pkg.incidents.build_info_snapshot(pkg.Registry()) == {}


def test_fault_snapshot_reflects_armed_plans(pkg):
    pkg.FAULTS.arm("incident.capture.stall", error="chaos")
    assert pkg.incidents.fault_snapshot()["incident.capture.stall"]["error"] == "chaos"


def test_thread_dump_names_this_thread(pkg):
    dump = pkg.incidents.thread_dump()
    assert "MainThread" in dump and "test_thread_dump" in dump


# -- the capturer -------------------------------------------------------------------


def test_debounce_suppresses_flapping_trigger(pkg, tmp_path):
    clk = FakeClock()
    store, cap = _capturer(pkg, tmp_path, clk, debounce=300.0)
    before = _captures(pkg, "slo-fast-burn", "debounced")
    first = cap.trigger("slo-fast-burn", sync=True)
    assert first is not None and cap.trigger("slo-fast-burn", sync=True) is None
    assert _captures(pkg, "slo-fast-burn", "debounced") == before + 1
    clk.advance(301.0)
    third = cap.trigger("slo-fast-burn", sync=True)
    assert third is not None and third != first and len(store.ids()) == 2


def test_near_in_time_triggers_coalesce_into_one_bundle(pkg, tmp_path):
    clk = FakeClock()
    store, cap = _capturer(pkg, tmp_path, clk, debounce=300.0, coalesce=60.0)
    i1 = cap.trigger("slo-fast-burn", {"slos": ["avail"]}, sync=True)
    clk.advance(5.0)
    assert cap.trigger("breaker-open", {"slos": ["latency"]}, sync=True) == i1
    assert store.ids() == [i1]
    m = store.load_manifest(i1)
    assert m["trigger"] == "slo-fast-burn"
    assert [t["trigger"] for t in m["triggers"]] == ["slo-fast-burn", "breaker-open"]
    assert m["sloFastBurning"] == ["avail", "latency"]


def _pinned_capture(pkg, tmp_path):
    clk = FakeClock()
    store, cap = _capturer(pkg, tmp_path, clk)
    cap.add_source("health", lambda: {"status": "ok"})
    cap.add_source("slo_status", lambda: {"fastBurning": ["avail"]})
    cap.add_source("broken", lambda: 1 / 0)
    tsdb = pkg.TimeSeriesStore(pkg.Registry(), clock=clk)
    tsdb.record("pio_probe_requests_total", {"path": "/q"}, 7.0)
    cap.set_history(tsdb, lambda: ["pio_probe_requests_total", "bad{selector"],
                    window=900.0)
    return store, store.load_bundle(cap.trigger("slo-fast-burn", sync=True))


def test_capture_pins_sources_history_and_faults(pkg, tmp_path):
    before = _captures(pkg, "slo-fast-burn", "ok")
    _, bundle = _pinned_capture(pkg, tmp_path)
    assert _captures(pkg, "slo-fast-burn", "ok") == before + 1
    m = bundle["manifest"]
    assert m["process"] == "test" and m["sloFastBurning"] == ["avail"]
    assert m["metricsWindowSeconds"] == 900.0
    assert set(m["files"]) >= {"manifest.json", "health.json", "slo_status.json",
                               "broken.json", "traces.json", "faults.json",
                               "metrics_history.json"}
    files = bundle["files"]
    assert files["health.json"] == {"status": "ok"}
    assert files["broken.json"]["error"].startswith("ZeroDivisionError")
    assert files["metrics_history.json"]["windowSeconds"] == 900.0
    assert any(k.startswith("pio_probe_requests_total")
               for k in files["metrics_history.json"]["series"])
    assert "exemplarTraceIds" in files["traces.json"]


def test_capture_stall_fault_is_fail_open(pkg, tmp_path):
    clk = FakeClock()
    store, cap = _capturer(pkg, tmp_path, clk)
    pkg.FAULTS.arm("incident.capture.stall", error="chaos")
    before = _captures(pkg, "slo-fast-burn", "error")
    iid = cap.trigger("slo-fast-burn", sync=True)
    assert iid is not None and _captures(pkg, "slo-fast-burn", "error") == before + 1
    assert store.load_manifest(iid) is None
    pkg.FAULTS.disarm()
    clk.advance(cap.debounce + 1)
    assert store.load_manifest(cap.trigger("slo-fast-burn", sync=True)) is not None


def test_async_trigger_joins(pkg, tmp_path):
    store, cap = _capturer(pkg, tmp_path, FakeClock())
    iid = cap.trigger("replica-down", {"url": "http://x"})
    cap.join(5.0)
    assert store.load_manifest(iid)["triggers"][0]["detail"] == {"url": "http://x"}


def test_capture_prunes_store(pkg, tmp_path):
    clk = FakeClock()
    store = pkg.incidents.IncidentStore(str(tmp_path), retain=1, clock=clk)
    cap = pkg.incidents.IncidentCapturer(store, "test", debounce=0.0, coalesce=0.0,
                                         clock=clk)
    for _ in range(3):
        cap.trigger("slo-fast-burn", sync=True)
        clk.advance(61.0)
    assert len(store.ids()) == 1


def test_excepthook_captures_then_chains(pkg, tmp_path):
    store, cap = _capturer(pkg, tmp_path, FakeClock())
    chained = []
    sys.excepthook = lambda *a: chained.append(a)
    pkg.incidents.install_crash_handlers(cap, install_signals=False)
    try:
        raise ValueError("boom")
    except ValueError:
        sys.excepthook(*sys.exc_info())
    assert len(chained) == 1
    (iid,) = store.ids()
    assert iid.endswith("-crash")
    assert store.load_manifest(iid)["triggers"][0]["detail"]["exception"] == \
        "ValueError: boom"
    with open(os.path.join(store.path(iid), "crash_traceback.txt")) as f:
        assert "ValueError: boom" in f.read()


def test_keyboard_interrupt_is_a_stop_not_a_crash_in_the_port(tmp_path):
    store, cap = _capturer(PACKAGES["torch"], tmp_path, FakeClock())
    chained = []
    sys.excepthook = lambda *a: chained.append(a)
    port_incidents.install_crash_handlers(cap, install_signals=False)
    try:
        raise KeyboardInterrupt
    except KeyboardInterrupt:
        sys.excepthook(*sys.exc_info())
    assert len(chained) == 1 and store.ids() == []


# -- diagnose (tests/test_incidents.py) ------------------------------------------------

BUNDLE = {
    "manifest": {
        "sloFastBurning": ["avail"],
        "faults": {"router.replica.down": {"error": "drill"}},
        "exemplars": [{"valueMs": 123.0, "series": "pio_t_seconds", "traceId": "t1"}],
        "triggers": [{"trigger": "slo-fast-burn"}, {"trigger": "breaker-open"}],
    },
    "files": {
        "replicas.json": {"replicas": [
            {"url": "http://a", "state": "down", "breaker": "open"},
            {"url": "http://b", "state": "not-ready"},
            {"url": "http://c", "state": "ready", "breaker": "open"},
        ]},
        "metrics_history.json": {"series": {
            'pio_engine_shed_total{app="x"}': [[1.0, 0.0], [2.0, 5.0]],
            'pio_probe_requests_total': [[1.0, 3.0], [2.0, 3.0]],
            'pio_variant_requests_total{variant="challenger"}': [[1.0, 1.0], [1.5, 2.0]],
        }},
    },
}


def test_diagnose_ranks_and_exit_code(pkg):
    findings = pkg.incidents.diagnose(BUNDLE)
    sev = [f["severity"] for f in findings]
    assert sev == sorted(sev, reverse=True)
    titles = "\n".join(f["title"] for f in findings)
    for want in ("SLO avail fast-burning", "router.replica.down", "http://a was down",
                 "http://b was not-ready", "tenant pressure", "moved first",
                 "2 triggers coalesced"):
        assert want in titles
    assert pkg.incidents.exit_code(findings) == 2


def test_diagnose_clean_bundle_exits_zero(pkg):
    findings = pkg.incidents.diagnose({"manifest": {}, "files": {}})
    assert findings == [] and pkg.incidents.exit_code(findings) == 0


def test_diagnose_live(pkg):
    findings = pkg.incidents.diagnose_live(
        {"fastBurning": ["avail"],
         "slos": [{"name": "lat", "slowBurn": True, "fastBurn": False}]},
        {"status": "degraded", "reason": "replica down"},
        {"replicas": [{"url": "http://a", "state": "down", "breaker": "open",
                       "modelGeneration": 4}],
         "tenantSheds": {"7": 2.0}, "probe": {"ok": 1.0, "error": 3.0}})
    assert pkg.incidents.exit_code(findings) == 2
    titles = "\n".join(f["title"] for f in findings)
    assert "fast-burning NOW" in titles and "slow-burning" in titles
    assert "degraded" in titles and findings[0]["severity"] == 2


def test_diagnose_live_quiet_fleet_exits_zero(pkg):
    assert pkg.incidents.exit_code(pkg.incidents.diagnose_live({}, {"status": "ok"},
                                                               {})) == 0


# -- the packages against each other ---------------------------------------------------


def test_one_capture_gives_equal_bundles(tmp_path):
    out = {}
    for name, pkg in PACKAGES.items():
        store, bundle = _pinned_capture(pkg, tmp_path / name)
        m = bundle["manifest"]
        out[name] = (store.ids(), sorted(m), m["files"], m["trigger"],
                     [t["trigger"] for t in m["triggers"]], m["sloFastBurning"],
                     {k: v for k, v in bundle["files"].items()
                      if k in ("health.json", "broken.json", "slo_status.json",
                               "metrics_history.json")})
    assert out["torch"] == out["jax"]


def test_diagnose_agrees_on_bundles_either_package_wrote(tmp_path):
    for writer in PACKAGES.values():
        store = writer.incidents.IncidentStore(str(tmp_path))
        store.write_bundle("20240101T000000-x", BUNDLE["files"], BUNDLE["manifest"])
        findings = {name: pkg.incidents.diagnose(
            pkg.incidents.IncidentStore(str(tmp_path)).load_bundle("20240101T000000-x"))
            for name, pkg in PACKAGES.items()}
        assert findings["torch"] == findings["jax"] and findings["torch"]
        assert jax_incidents.diagnose_live({"fastBurning": ["a"]}, {}, {}) == \
            port_incidents.diagnose_live({"fastBurning": ["a"]}, {}, {})
        shutil.rmtree(tmp_path / "20240101T000000-x")


def test_incidents_verbs_on_twin_homes(tmp_path, capsys, monkeypatch):
    # the exemplars come from the process's metrics registry, which other
    # tests in this process may have filled: pin one for both packages
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg.incidents, "collect_exemplars", lambda *a, **k: [
            {"series": "pio_engine_query_seconds", "labels": {"status": "200"},
             "le": "0.005", "traceId": "t1", "valueMs": 2.5}])
    tw = Twins(tmp_path, capsys)
    tw.run("incidents", "list", "--dir", "{home}/incidents")
    for name, pkg in PACKAGES.items():
        clk = FakeClock()
        home = tw.homes["port" if name == "torch" else name]
        store = pkg.incidents.IncidentStore(os.path.join(home, "incidents"), clock=clk)
        cap = pkg.incidents.IncidentCapturer(store, "engine", clock=clk)
        cap.add_source("health", lambda: {"status": "degraded"})
        cap.trigger("breaker-open", {"breaker": "engine_feedback_sink"}, sync=True)
        clk.advance(3600)
        pkg.FAULTS.arm("serving.query", latency=0.5)
        cap.trigger("crash", {"exception": "ValueError: boom"}, sync=True)
        pkg.FAULTS.disarm()
        store.write_bundle("20230101T000000-half", {}, {"trigger": "x"})
        os.remove(os.path.join(store.path("20230101T000000-half"), "manifest.json"))
    for argv in (("incidents", "list", "--dir", "{home}/incidents"),
                 ("incidents", "show", "20231114T221320-breaker-open", "--dir",
                  "{home}/incidents"),
                 ("incidents", "show", "--dir", "{home}/incidents"),
                 ("incidents", "show", "nope", "--dir", "{home}/incidents"),
                 ("incidents", "prune", "--retain", "1", "--dir", "{home}/incidents"),
                 ("incidents", "list", "--dir", "{home}/incidents")):
        tw.run(*argv)
    code, lines, _ = tw.run("incidents", "list", "--json", "--dir", "{home}/incidents")
    rows = json.loads("\n".join(lines))
    assert code == 0 and [r["id"] for r in rows] == ["20231114T231320-crash"]
    assert rows[0]["faults"] == ["serving.query"]


# -- the servers write bundles ------------------------------------------------------


def test_dead_feedback_sink_writes_one_breaker_bundle(trained_home, tmp_path,  # noqa: F811
                                                      monkeypatch):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    home = str(tmp_path / "home")
    shutil.copytree(trained_home, home)
    incident_dir = str(tmp_path / "incidents")
    engine = EngineServer(engine_factory=FACTORY, host="127.0.0.1", port=0,
                          device="cpu", storage=Storage(StorageConfig(home=home)),
                          feedback=True, event_sink=FailingSink(),
                          incident_dir=incident_dir)
    with ServerThread(engine) as t:
        assert all(jcall(t.port, "POST", "/queries.json", {"user": "1", "num": 2})[0]
                   == 200 for _ in range(10))
        wait_for(lambda: engine._feedback_inflight == 0)
        engine.incidents.join(10)
    store = port_incidents.IncidentStore(incident_dir)
    (iid,) = store.ids()
    bundle = store.load_bundle(iid)
    m = bundle["manifest"]
    assert m["process"] == "engine" and m["trigger"] == "breaker-open"
    assert m["triggers"][0]["detail"] == {"breaker": "engine_feedback_sink"}
    health = bundle["files"]["health.json"]
    assert health["breakers"]["feedback_sink"] == "open" and health["loaded"]
    assert bundle["files"]["metrics_history.json"]["windowSeconds"] == 900.0


def test_failing_group_commit_writes_one_breaker_bundle(tmp_path):
    storage = Storage(StorageConfig(home=str(tmp_path / "home")))
    a = storage.meta.create_app("A")
    storage.events.init_channel(a.id)
    key = storage.meta.create_access_key(a.id).key
    server = EventServer(storage=storage, host="127.0.0.1", port=0, ingest_batching=True,
                         incident_dir="auto")
    ev = {"event": "view", "entityType": "user", "entityId": "u", "targetEntityType":
          "item", "targetEntityId": "i"}
    with ServerThread(server) as t:
        port_faults.FAULTS.arm("ingest.commit", error="event storage down")
        codes = [jcall(t.port, "POST", f"/events.json?accessKey={key}", ev)[0]
                 for _ in range(server._ingest.breaker.failure_threshold + 1)]
        port_faults.FAULTS.disarm()
        server.incidents.join(10)
    assert codes[-1] == 503 and set(codes[:-1]) == {500}
    store = port_incidents.IncidentStore(os.path.join(str(tmp_path / "home"), "incidents"))
    (iid,) = store.ids()
    bundle = store.load_bundle(iid)
    assert bundle["manifest"]["process"] == "events"
    assert bundle["manifest"]["triggers"][0]["detail"] == {"breaker": "ingest_storage"}
    assert bundle["manifest"]["faults"]["ingest.commit"]["error"] == "event storage down"
    assert bundle["files"]["health.json"]["ingest"]["breaker"] == "open"
