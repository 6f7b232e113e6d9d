"""Feedback, plugins, tenant quotas and the group commit's fault site,
held against the JAX package's, on the CPU.

Unit cases run once on each package (``pkg``): the HTTP sink's retry
rules of ``tests/test_serving_resilience.py`` (a 429 retried after the
server's hint, a 4xx never retried, the ``eventsink.send`` site on the
direct sink) and its redirects of ``tests/test_replication.py``, the
feedback breaker over a failing sink, the cases of ``tests/test_plugins.py``
(``reset_plugins`` on both packages around each test), the event
server's quota cases of ``tests/test_tenancy.py`` that need no EVENTLOG,
and ``ingest.commit`` tripping the storage breaker. Then the packages
against each other, on twin copies of one home the JAX package trained:
feedback through an event server over HTTP and through the direct sink
gives equal ``predict`` rows (ids, times and prIds aside; scores within
1e-5 relative), and ``app quota`` prints the same lines and writes the
same ``quotas.json``. The port's own checks: a feedback backlog goes out
in batches of at most 50 (``/batch/events.json``, per-item refusals
counted), and the feedback span joins the query's trace.
"""

import http.client
import json
import os
import shutil
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from predictionio_tpu.core import plugins as jax_plugins
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.server import eventsink as jax_eventsink
from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu.server.event_server import EventServer as JaxEventServer
from predictionio_tpu.server.tenancy import TenantQuotas as JaxTenantQuotas
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu_torch.core import plugins as port_plugins
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.server import eventsink as port_eventsink
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.server.event_server import EventServer
from predictionio_tpu_torch.server.tenancy import TenantQuotas
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.utils import faults as port_faults
from tests.test_replication import _Leader, _Redirector, _serve
from tests.test_serving_resilience import ThrottlingEventStub
from tests.test_torch_cli import Twins
from tests.test_torch_event_server import ServerThread
from tests.test_torch_ops_surface import jcall, wait_for
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

PACKAGES = {
    "jax": types.SimpleNamespace(
        eventsink=jax_eventsink, Event=JaxEvent, plugins=jax_plugins,
        Engine=JaxEngineServer, Events=JaxEventServer, Quotas=JaxTenantQuotas,
        Storage=JaxStorage, StorageConfig=JaxStorageConfig, FAULTS=jax_faults.FAULTS,
        FaultError=jax_faults.FaultError, device_kw={}),
    "torch": types.SimpleNamespace(
        eventsink=port_eventsink, Event=Event, plugins=port_plugins,
        Engine=EngineServer, Events=EventServer, Quotas=TenantQuotas,
        Storage=Storage, StorageConfig=StorageConfig, FAULTS=port_faults.FAULTS,
        FaultError=port_faults.FaultError, device_kw={"device": "cpu"}),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    monkeypatch.delenv("PIO_PLUGINS", raising=False)
    for p in PACKAGES.values():
        p.FAULTS.disarm()
        p.plugins.reset_plugins()
    yield
    for p in PACKAGES.values():
        p.FAULTS.disarm()
        p.plugins.reset_plugins()


@pytest.fixture(scope="module")
def trained_home(tmp_path_factory):
    """One home with seeded ratings (app TestApp) and one JAX-trained
    instance of the Recommendation template."""
    home = str(tmp_path_factory.mktemp("feedback") / "home")
    storage = JaxStorage(JaxStorageConfig(home=home))
    seed_ratings(storage)
    jax_run_train(FACTORY, variant=VARIANT, storage=storage, use_mesh=False)
    return home


def _twin(pkg, trained_home, tmp_path, name):
    home = str(tmp_path / name)
    shutil.copytree(trained_home, home)
    return pkg.Storage(pkg.StorageConfig(home=home))


def _app(storage, name="FeedbackApp"):
    a = storage.meta.create_app(name)
    storage.events.init_channel(a.id)
    return a, storage.meta.create_access_key(a.id).key


def _drain(server):
    wait_for(lambda: server._feedback_inflight == 0)


# -- the HTTP sink (tests/test_serving_resilience.py, test_replication.py) -----


def _event(pkg):
    return pkg.Event(event="rate", entity_type="user", entity_id="7",
                     target_entity_type="item", target_entity_id="3",
                     properties={"rating": 5.0})


def test_429_is_retried_after_the_servers_hint(pkg):
    stub = ThrottlingEventStub(0, throttles=1)
    with ServerThread(stub) as t:
        sink = pkg.eventsink.HTTPEventSink(f"http://127.0.0.1:{t.port}", "key",
                                           retries=2)
        t0 = time.perf_counter()
        assert sink.send(_event(pkg)) == "e1"
        assert stub.posts == 2 and time.perf_counter() - t0 >= 0.28


def test_4xx_rejection_is_never_retried(pkg):
    stub = ThrottlingEventStub(0, reject=400)
    with ServerThread(stub) as t:
        sink = pkg.eventsink.HTTPEventSink(f"http://127.0.0.1:{t.port}", "key",
                                           retries=3)
        with pytest.raises(ValueError, match="rejected"):
            sink.send(_event(pkg))
        assert stub.posts == 1


def test_fault_site_covers_the_direct_sink(pkg, tmp_path):
    storage = pkg.Storage(pkg.StorageConfig(home=str(tmp_path)))
    a, _ = _app(storage, "SinkApp")
    sink = pkg.eventsink.DirectEventSink(storage, "SinkApp")
    pkg.FAULTS.arm("eventsink.send", error="sink down")
    with pytest.raises(pkg.FaultError):
        sink.send(_event(pkg))
    pkg.FAULTS.disarm()
    sink.send(_event(pkg))
    assert len(list(storage.events.find(a.id))) == 1


def test_sink_follows_a_307_and_bounds_a_redirect_loop(pkg):
    leader, leader_url = _serve(_Leader)
    _Redirector.leader_url = leader_url
    follower, follower_url = _serve(_Redirector)

    class _Loop(_Redirector):
        pass

    loop, loop_url = _serve(_Loop)
    _Loop.leader_url = loop_url
    try:
        sink = pkg.eventsink.HTTPEventSink(follower_url, "k", retries=0)
        assert sink.send(pkg.Event(event="e", entity_type="u", entity_id="1")) \
            == "ev-307-followed"
        sink = pkg.eventsink.HTTPEventSink(loop_url, "k", retries=0)
        with pytest.raises(RuntimeError, match="redirect not followable"):
            sink.send(pkg.Event(event="e", entity_type="u", entity_id="1"))
    finally:
        for srv in (leader, follower, loop):
            srv.shutdown()


# -- feedback through both sinks, on twin homes ---------------------------------


def _predict_rows(storage, app_id):
    rows = []
    for e in storage.events.find(app_id, event_names=["predict"]):
        assert e.entity_type == "pio_pr" and e.entity_id == e.pr_id
        props = json.loads(json.dumps(e.properties))
        assert props["prediction"].pop("prId") == e.pr_id
        rows.append((e.event, e.entity_type, props))
    return sorted(rows, key=lambda r: r[2]["query"]["user"])


def _same_rows(a, b):
    assert len(a) == len(b) > 0
    for (ea, ta, pa), (eb, tb, pb) in zip(a, b):
        assert (ea, ta, pa["query"]) == (eb, tb, pb["query"])
        sa, sb = pa["prediction"]["itemScores"], pb["prediction"]["itemScores"]
        assert [x["item"] for x in sa] == [x["item"] for x in sb]
        assert np.allclose([x["score"] for x in sa], [x["score"] for x in sb], rtol=1e-5)


USERS = [str(u) for u in range(12)]


@pytest.mark.parametrize("sink", ["http", "direct"])
def test_feedback_rows_are_equal_through_both_sinks(trained_home, tmp_path, sink):
    rows = {}
    for name, pkg in (("jax", PACKAGES["jax"]), ("torch", PACKAGES["torch"])):
        storage = _twin(pkg, trained_home, tmp_path, name)
        if sink == "http":
            app, key = _app(storage)
            es_ctx = ServerThread(pkg.Events(storage=storage, host="127.0.0.1", port=0))
        else:
            app, es_ctx = storage.meta.get_app_by_name("TestApp"), _nothing()
        with es_ctx as es:
            kw = ({"feedback_url": f"http://127.0.0.1:{es.port}",
                   "feedback_access_key": key} if sink == "http" else {"feedback": True})
            engine = pkg.Engine(engine_factory=FACTORY, storage=storage,
                                host="127.0.0.1", port=0, **pkg.device_kw, **kw)
            with ServerThread(engine) as t:
                got = [jcall(t.port, "POST", "/queries.json", {"user": u, "num": 4})[1]
                       for u in USERS]
                _drain(engine)
        assert all("prId" in a for a in got)
        rows[name] = _predict_rows(storage, app.id)
        assert dict(engine._m_feedback.items()).get(("ok",), 0) >= len(USERS)
    _same_rows(rows["torch"], rows["jax"])
    assert len(rows["torch"]) == len(USERS)


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_bad_access_key_is_rejected_not_fatal(pkg, trained_home, tmp_path):
    storage = _twin(pkg, trained_home, tmp_path, "home")
    app, _ = _app(storage)
    with ServerThread(pkg.Events(storage=storage, host="127.0.0.1", port=0)) as es:
        engine = pkg.Engine(engine_factory=FACTORY, storage=storage, host="127.0.0.1",
                            port=0, feedback_url=f"http://127.0.0.1:{es.port}",
                            feedback_access_key="wrong-key", **pkg.device_kw)
        with ServerThread(engine) as t:
            code, pred, _ = jcall(t.port, "POST", "/queries.json", {"user": "1", "num": 2})
            assert code == 200 and "prId" in pred
            _drain(engine)
    assert list(storage.events.find(app.id, event_names=["predict"])) == []
    assert dict(engine._m_feedback.items()).get(("error",), 0) >= 1


class FailingSink:
    """An EventSink whose dependency is hard-down."""

    def __init__(self):
        self.attempts = 0

    def send(self, event):
        self.attempts += 1
        raise OSError("event server unreachable")


def test_sustained_sink_failure_opens_the_breaker(pkg, trained_home, tmp_path):
    storage = _twin(pkg, trained_home, tmp_path, "home")
    sink = FailingSink()
    engine = pkg.Engine(engine_factory=FACTORY, storage=storage, host="127.0.0.1",
                        port=0, feedback=True, event_sink=sink, **pkg.device_kw)
    with ServerThread(engine) as t:
        for u in range(12):
            assert jcall(t.port, "POST", "/queries.json",
                         {"user": str(u % 5), "num": 2})[0] == 200
        _drain(engine)
        code, health, _ = jcall(t.port, "GET", "/health")
    counts = {k[0]: v for k, v in engine._m_feedback.items()}
    assert engine._sink_breaker.state == "open" and sink.attempts < 12
    assert counts.get("breaker_open", 0) >= 1
    assert counts.get("error", 0) >= engine._sink_breaker.failure_threshold
    assert code == 200 and health["status"] == "degraded"
    assert "feedback_sink" in health["reason"]


# -- plugins (tests/test_plugins.py) ----------------------------------------------


def _gate(pkg):
    class Gate(pkg.plugins.EventServerPlugin):
        name = "gate"

        def __init__(self):
            self.sniffed = []

        def input_blocker(self, event, app_id, channel_id):
            return "forbidden event name" if event.event == "forbidden" else None

        def input_sniffer(self, event, app_id, channel_id):
            self.sniffed.append((event.event, app_id))

    return Gate()


def _stamp(pkg):
    class Stamp(pkg.plugins.EngineServerPlugin):
        name = "stamp"

        def __init__(self):
            self.sniffed = 0

        def output_blocker(self, query, prediction):
            return {**prediction, "stamped": True} if isinstance(prediction, dict) \
                else prediction

        def output_sniffer(self, query, prediction):
            self.sniffed += 1

        def handle_route(self, subpath, body):
            return {"echo": subpath, "body": body}

    return Stamp()


@pytest.mark.parametrize("batching", [False, True])
def test_blocker_rejects_and_sniffer_observes(pkg, tmp_path, batching):
    storage = pkg.Storage(pkg.StorageConfig(home=str(tmp_path)))
    a, key = _app(storage, "QuickApp")
    gate = _gate(pkg)
    ok = {"event": "rate", "entityType": "user", "entityId": "u1",
          "targetEntityType": "item", "targetEntityId": "i1",
          "properties": {"rating": 4.0}}
    with ServerThread(pkg.Events(storage=storage, host="127.0.0.1", port=0,
                                 plugins=[gate], ingest_batching=batching)) as t:
        path = f"/events.json?accessKey={key}"
        assert jcall(t.port, "POST", path, ok)[0] == 201
        code, body, _ = jcall(t.port, "POST", path, {**ok, "event": "forbidden"})
        assert code == 403 and "forbidden" in body["message"]
        code, body, _ = jcall(t.port, "POST", f"/batch/events.json?accessKey={key}",
                              [ok, {**ok, "event": "forbidden"}])
        assert [r["status"] for r in body] == [201, 403]
    assert [e.event for e in storage.events.find(a.id)] == ["rate", "rate"]
    assert gate.sniffed == [("rate", a.id)] * 2


def test_output_blocker_routes_and_listing(pkg, trained_home, tmp_path):
    storage = _twin(pkg, trained_home, tmp_path, "home")
    stamp = _stamp(pkg)
    with ServerThread(pkg.Engine(engine_factory=FACTORY, storage=storage,
                                 host="127.0.0.1", port=0, plugins=[stamp],
                                 **pkg.device_kw)) as t:
        code, pred, _ = jcall(t.port, "POST", "/queries.json", {"user": "2", "num": 3})
        assert code == 200 and pred["stamped"] is True and stamp.sniffed == 1
        code, listing, _ = jcall(t.port, "GET", "/plugins.json")
        assert code == 200 and listing == {"plugins": {
            "outputblockers": ["stamp"], "outputsniffers": ["stamp"]}}
        assert jcall(t.port, "POST", "/plugins/stamp/sub/path", {"x": 1})[:2] == \
            (200, {"echo": "sub/path", "body": {"x": 1}})
        assert jcall(t.port, "GET", "/plugins/stamp/a/b")[:2] == \
            (200, {"echo": "a/b", "body": None})
        assert jcall(t.port, "GET", "/plugins/nope/x")[0] == 404


def test_pio_plugins_spec_loads_instance_and_class(pkg, tmp_path, monkeypatch):
    name = f"my_plugins_{id(pkg)}"
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(f"""
        from {pkg.plugins.__name__} import EngineServerPlugin, EventServerPlugin

        class Gate(EventServerPlugin):
            name = "env-gate"

        plugin = Gate()

        class Stamp(EngineServerPlugin):
            name = "env-stamp"
    """))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PIO_PLUGINS", f"{name},{name}:Stamp")
    try:
        assert [p.name for p in pkg.plugins.event_server_plugins()] == ["env-gate"]
        assert [p.name for p in pkg.plugins.engine_server_plugins()] == ["env-stamp"]
        monkeypatch.setenv("PIO_PLUGINS", "nonexistent_mod:x")
        assert [p.name for p in pkg.plugins.event_server_plugins()] == ["env-gate"]
        # a server built without plugins= discovers them
        server = pkg.Events(storage=pkg.Storage(pkg.StorageConfig(home=str(tmp_path))),
                            host="127.0.0.1", port=0)
        assert [p.name for p in server.plugins] == ["env-gate"]
    finally:
        sys.modules.pop(name, None)


def test_bad_plugin_spec_raises(pkg, tmp_path, monkeypatch):
    name = f"not_a_plugin_{id(pkg)}"
    (tmp_path / f"{name}.py").write_text("plugin = object()\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PIO_PLUGINS", name)
    try:
        with pytest.raises(TypeError):
            pkg.plugins.event_server_plugins()
    finally:
        sys.modules.pop(name, None)


def test_programmatic_registration(pkg):
    g, s = _gate(pkg), _stamp(pkg)
    pkg.plugins.register_event_plugin(g)
    pkg.plugins.register_engine_plugin(s)
    assert pkg.plugins.event_server_plugins() == [g]
    assert pkg.plugins.engine_server_plugins() == [s]


# -- tenant quotas on the event server (tests/test_tenancy.py) -------------------


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"null"), r.headers
    finally:
        conn.close()


EV = {"event": "buy", "entityType": "user", "entityId": "u1",
      "targetEntityType": "item", "targetEntityId": "i1"}


@pytest.mark.parametrize("batching", [False, True])
def test_429_is_tenant_scoped_with_honest_retry_after(pkg, tmp_path, batching):
    storage = pkg.Storage(pkg.StorageConfig(home=str(tmp_path)))
    limited, lkey = _app(storage, "limited")
    unmetered, ukey = _app(storage, "unmetered")
    quotas = pkg.Quotas(str(tmp_path / "quotas.json"))
    quotas.set_quota(str(limited.id), rate=1.0, burst=3.0)
    server = pkg.Events(storage=storage, host="127.0.0.1", port=0,
                        tenant_quotas=quotas, ingest_batching=batching)
    # the metrics registry is the process's: count from here
    before = dict(server._m_quota.items())
    with ServerThread(server) as t:
        results = [_post(t.port, f"/events.json?accessKey={lkey}", EV) for _ in range(6)]
        throttled = [r for r in results if r[0] == 429]
        assert throttled and len(throttled) + sum(r[0] == 201 for r in results) == 6
        for _, body, headers in throttled:
            assert body["retryAfterSec"] > 0 and int(headers["Retry-After"]) >= 1
            assert "over its ingest quota" in body["message"]
        assert all(_post(t.port, f"/events.json?accessKey={ukey}", EV)[0] == 201
                   for _ in range(6))
        # a batch is charged as many events as it holds
        code, body, _ = _post(t.port, f"/batch/events.json?accessKey={lkey}", [EV] * 5)
        assert code == 429 and "5 event(s)" in body["message"]
        code, health, _ = jcall(t.port, "GET", "/health")
        assert health["tenantQuotas"] == str(tmp_path / "quotas.json")
    after = dict(server._m_quota.items())
    for app, want in ((limited, len(throttled) + 1), (unmetered, 0)):
        key = (str(app.id),)
        assert after.get(key, 0) - before.get(key, 0) == want


def test_quota_exhausted_fault_drills_the_servers_429(pkg, tmp_path):
    storage = pkg.Storage(pkg.StorageConfig(home=str(tmp_path)))
    _, key = _app(storage, "drilled")
    with ServerThread(pkg.Events(storage=storage, host="127.0.0.1", port=0)) as t:
        path = f"/events.json?accessKey={key}"
        assert _post(t.port, path, EV)[0] == 201
        pkg.FAULTS.arm("tenant.quota.exhausted", error="drill")
        code, body, headers = _post(t.port, path, EV)
        assert code == 429 and int(headers["Retry-After"]) >= 1
        pkg.FAULTS.disarm("tenant.quota.exhausted")
        assert _post(t.port, path, EV)[0] == 201


def test_event_server_health_names_the_policy_file_in_both(tmp_path):
    out = {}
    for name, pkg in (("jax", PACKAGES["jax"]), ("torch", PACKAGES["torch"])):
        home = str(tmp_path / name)
        storage = pkg.Storage(pkg.StorageConfig(home=home))
        with ServerThread(pkg.Events(storage=storage, host="127.0.0.1", port=0)) as t:
            code, body, _ = jcall(t.port, "GET", "/health")
        out[name] = code, {k: (v.replace(home, "{home}") if isinstance(v, str) else v)
                           for k, v in body.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["tenantQuotas"] == "{home}/quotas.json"


def test_app_quota_verb_on_twin_homes(tmp_path, capsys):
    tw = Twins(tmp_path, capsys)
    tw.run("app", "new", "Tenant", "--access-key", "k1")
    tw.run("app", "quota", "Tenant")
    tw.run("app", "quota", "Tenant", "--rate", "5", "--burst", "10", "--weight", "2")
    tw.run("app", "quota", "Tenant", "--clear", "burst", "--writer-shards", "3")
    tw.run("app", "quota", "Nobody", "--rate", "1")
    with open(os.path.join(tw.homes["jax"], "quotas.json")) as a, \
            open(os.path.join(tw.homes["port"], "quotas.json")) as b:
        assert json.load(b) == json.load(a)


# -- ingest.commit: the storage breaker (tests/test_serving_resilience.py) -------


def test_storage_outage_trips_breaker_to_fast_503(pkg, tmp_path):
    storage = pkg.Storage(pkg.StorageConfig(home=str(tmp_path)))
    app, key = _app(storage, "BreakerApp")
    server = pkg.Events(storage=storage, host="127.0.0.1", port=0, ingest_batching=True)
    with ServerThread(server) as t:
        url = f"/events.json?accessKey={key}"
        assert _post(t.port, url, EV)[0] == 201
        pkg.FAULTS.arm("ingest.commit", error="event storage down")
        threshold = server._ingest.breaker.failure_threshold
        assert {_post(t.port, url, {**EV, "entityId": "lost"})[0]
                for _ in range(threshold)} == {500}
        assert server._ingest.breaker.state == "open"
        t0 = time.perf_counter()
        code, body, headers = _post(t.port, url, {**EV, "entityId": "lost"})
        assert code == 503 and "circuit breaker open" in body["message"]
        assert int(headers["Retry-After"]) >= 1 and time.perf_counter() - t0 < 0.5
        code, health, _ = jcall(t.port, "GET", "/health")
        assert code == 200 and health["status"] == "degraded"
        pkg.FAULTS.disarm()
        server._ingest.breaker.reset()
        assert _post(t.port, url, EV)[0] == 201
    assert list(storage.events.find(app.id, entity_id="lost")) == []
    assert len(list(storage.events.find(app.id))) == 2


# -- the port's batched feedback -------------------------------------------------


class SlowSink:
    """Records every send's size; each send takes 50 ms."""

    def __init__(self):
        self.sizes = []

    def send_batch(self, events):
        time.sleep(0.05)
        self.sizes.append(len(events))
        return [f"id-{e.pr_id}" for e in events]


def test_a_feedback_backlog_goes_out_in_batches(trained_home, tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    storage = _twin(PACKAGES["torch"], trained_home, tmp_path, "home")
    sink = SlowSink()
    engine = EngineServer(engine_factory=FACTORY, storage=storage, host="127.0.0.1",
                          port=0, event_sink=sink, device="cpu")
    with ServerThread(engine) as t:
        with ThreadPoolExecutor(8) as pool:
            codes = list(pool.map(lambda u: jcall(t.port, "POST", "/queries.json",
                                                  {"user": str(u % 30), "num": 2})[0],
                                  range(60)))
        _drain(engine)
    assert codes == [200] * 60 and sum(sink.sizes) == 60
    assert max(sink.sizes) > 1 and max(sink.sizes) <= engine._FEEDBACK_BATCH
    assert dict(engine._m_feedback.items()).get(("ok",), 0) >= 60


def test_http_sink_batches_go_to_the_batch_route(tmp_path):
    storage = Storage(StorageConfig(home=str(tmp_path)))
    a, key = _app(storage)
    server = EventServer(storage=storage, host="127.0.0.1", port=0,
                         plugins=[_gate(PACKAGES["torch"])])
    events = [Event(event="forbidden" if i == 7 else "predict", entity_type="pio_pr",
                    entity_id=f"p{i}", pr_id=f"p{i}") for i in range(50)]
    with ServerThread(server) as t:
        sink = port_eventsink.HTTPEventSink(f"http://127.0.0.1:{t.port}", key)
        ids = sink.send_batch(events)
        bad = port_eventsink.HTTPEventSink(f"http://127.0.0.1:{t.port}", "wrong")
        with pytest.raises(ValueError, match="401"):
            bad.send_batch(events[:3])
        with pytest.raises(ValueError, match="400"):  # past the batch limit
            sink.send_batch(events + events[:1])
    assert len(ids) == 50 and ids[7] is None and all(ids[:7] + ids[8:])
    stored = {e.event_id for e in storage.events.find(a.id)}
    assert stored == set(ids) - {None}


def test_feedback_span_joins_the_querys_trace(trained_home, tmp_path):
    from predictionio_tpu_torch.utils import tracing

    storage = _twin(PACKAGES["torch"], trained_home, tmp_path, "home")
    engine = EngineServer(engine_factory=FACTORY, storage=storage, host="127.0.0.1",
                          port=0, event_sink=SlowSink(), device="cpu")
    tracing.TRACER.reset()
    tracing.TRACER.configure(enabled=True)
    try:
        with ServerThread(engine) as t:
            code, _, hdrs = jcall(t.port, "POST", "/queries.json", {"user": "1", "num": 2})
            _drain(engine)
        trace = tracing.TRACER.ring.trace(hdrs["X-PIO-Trace-Id"])
    finally:
        tracing.TRACER.reset()
    names = {d["name"]: d for d in trace}
    assert code == 200 and {"engine.query", "engine.feedback"} <= set(names)
    assert names["engine.feedback"]["attrs"]["records"] == 1
    assert names["engine.feedback"]["parentId"] == names["engine.query"]["spanId"]
