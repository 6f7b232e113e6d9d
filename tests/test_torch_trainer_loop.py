"""The port's continuous trainer held against the JAX package's, on the CPU.

- The lease (``TrainerLease``): acquire, renew, release, fencing tokens,
  the ``train.lease.lost`` site, and the wall-clock jumps under
  ``FakeClock`` and ``JumpyClock``, each case on both packages; and one
  lease file that one package writes while the other acquires, renews
  and fences it.
- The loop with a stub ``train_fn`` (the JAX package's loop cases, the
  online gate's cases and the eval gate) on both packages.
- One real CPU cycle pair on twin homes holding the same events, each
  package training its own template: equal outcomes, equal
  ``trainer.state.json``, equal registry manifests (instance ids and
  digests normalised), factors within 1e-4 and guardrail RMSEs within
  1e-5.
- A SIGKILL mid-delta-train through the port's CLI (``train
  --continuous --device cpu``): the restarted trainer resumes from
  ``train_ckpt_torch/``, promotes exactly once at a bumped fencing token,
  and its factors equal a straight train's.
- ``_parse_prom``, ``_query_stats`` and ``_p95_from_delta`` against the
  JAX package's on the same text, and the metrics listener.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.data import events as jax_events
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.event import utcnow as jax_utcnow
from predictionio_tpu.server import trainer as jax_trainer
from predictionio_tpu.storage import meta as jax_meta
from predictionio_tpu.storage import models as jax_models
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.utils import faults as jax_faults
from predictionio_tpu.utils import metrics as jax_metrics
from predictionio_tpu_torch.core.workflow import (
    JAX_RECOMMENDATION_FACTORY,
    RECOMMENDATION_FACTORY,
    prepare_deploy,
    run_train,
)
from predictionio_tpu_torch.data import events as port_events
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.event import utcnow as port_utcnow
from predictionio_tpu_torch.server import trainer as port_trainer
from predictionio_tpu_torch.storage import meta as port_meta
from predictionio_tpu_torch.storage import models as port_models
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.utils import faults as port_faults
from predictionio_tpu_torch.utils import metrics as port_metrics
from tests.test_torch_eventlog import T0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_DIR = os.path.join(REPO, "predictionio_tpu_torch", "templates", "recommendation")

PKG = {
    "jax": types.SimpleNamespace(
        trainer=jax_trainer, events=jax_events, Event=JaxEvent, utcnow=jax_utcnow,
        meta=jax_meta, models=jax_models, registry=jax_registry, faults=jax_faults,
        metrics=jax_metrics),
    "port": types.SimpleNamespace(
        trainer=port_trainer, events=port_events, Event=Event, utcnow=port_utcnow,
        meta=port_meta, models=port_models, registry=port_registry, faults=port_faults,
        metrics=port_metrics),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jax_faults.FAULTS.disarm()
    port_faults.FAULTS.disarm()


@pytest.fixture()
def home_storage(tmp_path, request):
    """One package's in-memory backends over a real on-disk home (lease,
    registry and trainer state live under ``storage.config.home``)."""
    p = PKG[request.node.callspec.params["pkg"]]
    reg = p.registry
    st = reg.Storage(reg.StorageConfig(metadata_type="MEMORY", eventdata_type="MEMORY",
                                       modeldata_type="MEMORY", home=str(tmp_path)))
    st._meta = p.meta.MetaStore(":memory:")
    st._events = p.events.MemoryEventStore()
    st._models = p.models.MemoryModelStore()
    reg.set_storage(st)
    yield st
    reg.set_storage(None)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def clock(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


class JumpyClock:
    """Wall and monotonic clocks that tick together; a test jumps the
    wall alone."""

    def __init__(self):
        self.wall = 1000.0
        self.mono = 50.0

    def clock(self):
        return self.wall

    def monotonic(self):
        return self.mono

    def sleep(self, seconds):
        self.wall += seconds
        self.mono += seconds

    def tick(self, seconds):
        self.wall += seconds
        self.mono += seconds


def _lease(p, path, owner, clk, jumpy=False):
    kw = {"mono": clk.monotonic} if jumpy else {}
    return p.trainer.TrainerLease(str(path), owner, ttl=30.0, clock=clk.clock,
                                  sleep=clk.sleep, **kw)


# -- the lease -----------------------------------------------------------------


@BOTH
def test_acquire_renew_release_token_monotonic(tmp_path, pkg):
    p, clk = PKG[pkg], FakeClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk)
    assert a.acquire() and a.token == 1
    a.renew()
    a.release()
    b = _lease(p, tmp_path / "t.lease", "b:2", clk)
    assert b.acquire() and b.token == 2


@BOTH
def test_held_lease_refuses_second_acquirer(tmp_path, pkg):
    p, clk = PKG[pkg], FakeClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk)
    b = _lease(p, tmp_path / "t.lease", "b:2", clk)
    assert a.acquire()
    assert not b.acquire()


@BOTH
def test_expired_lease_is_stolen_and_renew_detects_it(tmp_path, pkg):
    p, clk = PKG[pkg], FakeClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk)
    b = _lease(p, tmp_path / "t.lease", "b:2", clk)
    assert a.acquire()
    clk.t += 31.0
    assert b.acquire() and b.token == 2
    with pytest.raises(p.trainer.LeaseLost):
        a.renew()


@BOTH
def test_train_lease_lost_fault_site(tmp_path, pkg):
    p, clk = PKG[pkg], FakeClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk)
    assert a.acquire()
    p.faults.FAULTS.arm("train.lease.lost", error="lease stolen")
    with pytest.raises(p.trainer.LeaseLost):
        a.renew()


@BOTH
def test_forward_wall_jump_does_not_self_expire_live_lease(tmp_path, pkg):
    p, clk = PKG[pkg], JumpyClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk, jumpy=True)
    b = _lease(p, tmp_path / "t.lease", "b:2", clk, jumpy=True)
    assert a.acquire()
    assert not b.acquire()
    clk.tick(5.0)
    a.renew()
    assert not b.acquire()
    clk.wall += 10_000.0
    assert not b.acquire()
    a.renew()
    assert not b.acquire()
    clk.tick(31.0)
    assert b.acquire() and b.token == 2
    with pytest.raises(p.trainer.LeaseLost):
        a.renew()


@BOTH
def test_backward_wall_jump_does_not_immortalize_dead_lease(tmp_path, pkg):
    p, clk = PKG[pkg], JumpyClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk, jumpy=True)
    b = _lease(p, tmp_path / "t.lease", "b:2", clk, jumpy=True)
    assert a.acquire()
    clk.wall -= 10_000.0
    assert not b.acquire()
    clk.tick(31.0)
    assert b.acquire() and b.token == 2


@BOTH
def test_renewal_changes_document_every_beat(tmp_path, pkg):
    p, clk = PKG[pkg], JumpyClock()
    a = _lease(p, tmp_path / "t.lease", "a:1", clk, jumpy=True)
    assert a.acquire()
    before = (tmp_path / "t.lease").read_text()
    clk.wall -= 30.0
    a.renew()
    after = (tmp_path / "t.lease").read_text()
    assert before != after and json.loads(after)["beat"] == 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_one_lease_file_across_packages(tmp_path, writer, reader):
    """A lease one package holds is refused, stolen after expiry, renewed
    and fenced by the other, byte for byte on one file."""
    clk = FakeClock()
    w = _lease(PKG[writer], tmp_path / "t.lease", "w:1", clk)
    r = _lease(PKG[reader], tmp_path / "t.lease", "r:2", clk)
    assert w.acquire() and w.token == 1
    w.renew()
    assert json.loads((tmp_path / "t.lease").read_text())["beat"] == 1
    assert not r.acquire()
    clk.t += 31.0
    assert r.acquire() and r.token == 2
    with pytest.raises(PKG[writer].trainer.LeaseLost):
        w.renew()
    r.renew()
    r.release()
    doc = json.loads((tmp_path / "t.lease").read_text())
    assert doc == {"owner": "r:2", "token": 2, "expires": 0, "beat": 1}
    assert w.acquire() and w.token == 3
    # the reader's registry fence refuses the superseded token
    reg = PKG[reader].models.ModelRegistry(str(tmp_path / "model_registry"))
    reg.register("i1", b"blob", token=w.token)
    with pytest.raises(PKG[reader].models.FencedWriteError):
        reg.register("late", b"late", token=2)


# -- the loop with a stub train_fn ---------------------------------------------


def _seed_events(p, storage, app_name="LoopApp", n=12):
    app = storage.meta.create_app(app_name)
    storage.events.init_channel(app.id)
    storage.events.insert_batch(
        [p.Event(event="rate", entity_type="user", entity_id=str(i % 4),
                 target_entity_type="item", target_entity_id=str(i % 3),
                 properties={"rating": float(1 + i % 5)}) for i in range(n)], app.id)
    return app


def _more(p, storage, user, rating, n=6):
    app = storage.meta.get_app_by_name("LoopApp")
    storage.events.insert_batch(
        [p.Event(event="rate", entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id="1",
                 properties={"rating": rating}) for _ in range(n)], app.id)


def _stub_train(p, storage, blob=b"model-blob-v1"):
    def train_fn(storage=storage, **_kw):
        iid = storage.meta.new_instance_id()
        storage.meta.insert_engine_instance(p.meta.EngineInstance(
            id=iid, status="COMPLETED", start_time=p.utcnow(), end_time=p.utcnow(),
            engine_factory="stub:factory", engine_variant="", batch="continuous",
            env={}, mesh_conf={}, data_source_params="{}", preparator_params="{}",
            algorithms_params='[{"name": "als", "params": {"rank": 4}}]',
            serving_params="{}"))
        storage.models.put(iid, blob)
        return iid
    return train_fn


def _trainer(p, storage, clock, http=None, **cfg_kw):
    cfg_kw.update(dict(device="cpu") if p is PKG["port"] else dict(use_mesh=False))
    cfg = p.trainer.TrainerConfig(engine_factory="stub:factory", app_name="LoopApp",
                                  poll_interval=0.5, lease_ttl=30.0, **cfg_kw)
    return p.trainer.ContinuousTrainer(cfg, storage=storage, clock=clock.clock,
                                       sleep=clock.sleep,
                                       train_fn=_stub_train(p, storage), http=http)


@BOTH
def test_single_wake_cycle_promotes_first_generation(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), min_delta_events=5)
    rec = t.run_once()
    assert (rec["outcome"], rec["generation"]) == ("promoted", 1)
    assert t.registry.champion()["gen"] == 1
    assert t.run_once()["outcome"] == "idle"
    _more(p, home_storage, "9", 5.0, n=5)
    rec2 = t.run_once()
    assert (rec2["outcome"], rec2["generation"]) == ("promoted", 2)
    if pkg == "port":
        assert set(t.timings) == {"train", "promote", "gate", "reload"}


@BOTH
def test_run_releases_lease_on_stop(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), min_delta_events=5)
    outcomes = t.run(max_cycles=2, install_signals=False)
    assert [r["outcome"] for r in outcomes] == ["promoted", "idle"]
    doc = json.loads(open(t.lease.path).read())
    assert doc["expires"] == 0 and doc["token"] == 1
    assert t.lease.token is None


@BOTH
def test_train_crash_fault_site_then_recovery(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), min_delta_events=5)
    p.faults.FAULTS.arm("train.crash", error="mid-train crash", count=1)
    with pytest.raises(p.faults.FaultError):
        t.run_once()
    assert t.registry.generations() == []
    rec = t.run_once()
    assert (rec["outcome"], rec["generation"]) == ("promoted", 1)


@BOTH
def test_guardrail_refuses_injected_regression(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), min_delta_events=5)
    assert t.run_once()["outcome"] == "promoted"
    _more(p, home_storage, "1", 3.0)
    p.faults.FAULTS.arm("promote.regression", error="regressed")
    rec = t.run_once()
    assert rec["outcome"] == "refused"
    assert t.registry.champion()["gen"] == 1
    entry = [e for e in t.registry.generations() if e["gen"] == rec["generation"]][0]
    assert entry["status"] == "refused"
    assert home_storage.meta.get_engine_instance(entry["instance_id"]).status == "REFUSED"


@BOTH
def test_second_trainer_against_held_lease_never_writes(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    clk = FakeClock()
    a = _trainer(p, home_storage, clk, min_delta_events=5)
    assert a.lease.acquire()
    b = _trainer(p, home_storage, clk, min_delta_events=5)
    assert b.run_once()["outcome"] == "lease-held"
    assert b.registry.generations() == []


@BOTH
def test_wedged_trainer_is_fenced_out_of_late_publish(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    clk = FakeClock()
    a = _trainer(p, home_storage, clk, min_delta_events=5)

    def stealing_train(**kw):
        clk.t += 40.0
        b = p.trainer.TrainerLease(a.lease.path, "b:2", ttl=30.0, clock=clk.clock,
                                   sleep=clk.sleep)
        assert b.acquire()
        return _stub_train(p, home_storage)()

    a._train_fn = stealing_train
    with pytest.raises(p.trainer.LeaseLost):
        a.run_once()
    assert a.registry.generations() == []


def _bake_http(scrapes):
    def fake_http(method, url):
        if url.endswith("/reload"):
            return "{}"
        scrapes["n"] += 1
        errs = 0 if scrapes["n"] == 1 else 50
        return ('pio_engine_queries_total{status="200"} 1000\n'
                f'pio_engine_queries_total{{status="500"}} {errs}\n'
                'pio_engine_query_seconds_bucket{status="200",le="0.1"} 900\n'
                'pio_engine_query_seconds_bucket{status="200",le="+Inf"} '
                f'{1000 + errs}\n')
    return fake_http


@BOTH
def test_bake_window_rolls_back_on_error_rate(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), http=_bake_http({"n": 0}),
                 min_delta_events=5, bake_seconds=0.0, bake_error_rate=0.01,
                 reload_urls=["http://replica:8000"])
    assert t.run_once()["outcome"] == "promoted"
    _more(p, home_storage, "7", 2.0)
    t.cfg.bake_seconds = 5.0
    rec = t.run_once()
    assert rec["outcome"] == "rolled_back" and rec["detail"]["restored"] == 1
    assert t.registry.champion()["gen"] == 1
    assert [e for e in t.registry.generations() if e["gen"] == 2][0]["status"] \
        == "rolled_back"
    latest = home_storage.meta.get_latest_completed_engine_instance("stub:factory", "")
    assert latest.id == t.registry.champion()["instance_id"]


def _metrics_text(champ_rmse, chal_rmse, pairs=50):
    return (f'pio_variant_online_rmse{{variant="champion"}} {champ_rmse}\n'
            f'pio_variant_online_rmse{{variant="challenger"}} {chal_rmse}\n'
            f'pio_variant_feedback_total{{variant="champion",kind="rating"}} {pairs}\n'
            f'pio_variant_feedback_total{{variant="challenger",kind="rating"}} {pairs}\n')


def _online(p, storage, text, **kw):
    http = lambda method, url: "{}" if url.endswith("/reload") else text  # noqa: E731
    return _trainer(p, storage, FakeClock(), http=http, min_delta_events=5,
                    gate="online", reload_urls=["http://replica:8000"], **kw)


@BOTH
@pytest.mark.parametrize("champ,chal,pairs,gate,outcome", [
    (0.80, 1.50, 50, "online", "refused"),
    (0.80, 0.79, 50, "online", "promoted"),
    (0.80, 9.9, 3, "online", "promoted"),
    (0.80, 1.50, 50, "both", "refused"),
])
def test_online_gate(home_storage, pkg, champ, chal, pairs, gate, outcome):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _online(p, home_storage, _metrics_text(champ, chal, pairs))
    t.cfg.gate = gate
    rec = t.run_once()
    assert rec["outcome"] == outcome
    detail = rec["detail"] if outcome == "refused" else rec["detail"]["gate"]
    if gate == "both":
        assert detail["mode"] == "both"
        assert detail["online"]["reason"].startswith("online rmse")
    elif pairs < 20:
        assert "pass" in detail["reason"]
    else:
        assert "online rmse" in detail["reason"]


@BOTH
def test_online_gate_injected_regression(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _online(p, home_storage, _metrics_text(0.80, 0.79))
    p.faults.FAULTS.arm("promote.regression", error="drill")
    rec = t.run_once()
    assert rec["outcome"] == "refused" and rec["detail"]["reason"] == "injected regression"


@BOTH
def test_eval_gate_without_a_leaderboard_passes(home_storage, pkg):
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), min_delta_events=5, gate="eval")
    rec = t.run_once()
    assert rec["outcome"] == "promoted"
    assert rec["detail"]["gate"]["reason"] == "no sweep leaderboard: pass"


# -- a real CPU cycle pair on twin homes ---------------------------------------


def _twin_events(p, lo, hi, seed):
    """Block-structured ratings (even users like even items) at a random
    half of the (user, item) grid, with ids and times of their own."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    cells = [(u, i) for u in range(30) for i in range(20) if rng.random() < 0.5]
    out = []
    for j in range(lo, hi):
        u, i = cells[(j * 37) % len(cells)]
        r = (5.0 if (u % 2) == (i % 2) else 1.0) if j < 200 else float(1 + j % 5)
        out.append(p.Event(event_id=f"ev{j:05d}", event="rate", entity_type="user",
                           entity_id=f"u{u}", target_entity_type="item",
                           target_entity_id=f"i{i}", properties={"rating": r},
                           event_time=T0 + dt.timedelta(seconds=j),
                           creation_time=T0 + dt.timedelta(days=1, seconds=j)))
    return out


def _variant(factory):
    return {"id": "loop", "engineFactory": factory,
            "datasource": {"params": {"appName": "LoopApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 8, "numIterations": 8, "lambda": 0.05, "seed": 3}}]}


def _normalised_registry(home):
    doc = json.loads(open(os.path.join(home, "model_registry", "registry.json")).read())
    for e in doc["generations"]:
        e["instance_id"] = "<id>"
        e["sha256"] = "<sha>"
    return doc


def test_real_cycles_on_twin_homes_match_the_jax_trainer(tmp_path):
    clocks, trainers, recs, stores = {}, {}, {}, {}
    for pkg, factory in (("jax", JAX_RECOMMENDATION_FACTORY),
                         ("port", RECOMMENDATION_FACTORY)):
        p = PKG[pkg]
        home = str(tmp_path / pkg)
        st = p.registry.Storage(p.registry.StorageConfig(home=home))
        app = st.meta.create_app("LoopApp")
        st.events.init_channel(app.id)
        st.events.insert_batch(_twin_events(p, 0, 200, 0), app.id)
        clocks[pkg] = FakeClock()
        kw = dict(device="cpu") if pkg == "port" else dict(use_mesh=False)
        cfg = p.trainer.TrainerConfig(
            engine_factory=factory, app_name="LoopApp", variant=_variant(factory),
            variant_id="loop", min_delta_events=1, poll_interval=0.2,
            guardrail_min_events=5, guardrail_holdout=40, **kw)
        trainers[pkg] = p.trainer.ContinuousTrainer(cfg, storage=st, clock=clocks[pkg].clock,
                                                    sleep=clocks[pkg].sleep)
        first = trainers[pkg].run_once()
        st.events.insert_batch(_twin_events(p, 200, 240, 0), app.id)
        clocks[pkg].t += 60.0
        second = trainers[pkg].run_once()
        idle = trainers[pkg].run_once()
        trainers[pkg].lease.release()
        recs[pkg] = (first, second, idle)
        stores[pkg] = st
    for a, b in zip(recs["jax"], recs["port"]):
        assert (a["outcome"], a["generation"]) == (b["outcome"], b["generation"])
    assert [r["outcome"] for r in recs["port"]] == ["promoted", "promoted", "idle"]
    gate = {pkg: recs[pkg][1]["detail"]["gate"] for pkg in recs}
    assert gate["jax"]["pairs"] == gate["port"]["pairs"] == 40
    for key in ("champion_rmse", "candidate_rmse"):
        assert gate["port"][key] == pytest.approx(gate["jax"][key], abs=1e-5)
    assert recs["jax"][2]["detail"] == recs["port"][2]["detail"]
    homes = {pkg: str(tmp_path / pkg) for pkg in recs}
    states = [open(os.path.join(h, "trainer.state.json")).read() for h in homes.values()]
    assert states[0] == states[1]
    assert _normalised_registry(homes["jax"]) == _normalised_registry(homes["port"])
    # each generation's factors
    for gen in (1, 2):
        iid = {pkg: [e for e in trainers[pkg].registry.generations()
                     if e["gen"] == gen][0]["instance_id"] for pkg in recs}
        jm = jax_prepare_deploy(instance_id=iid["jax"], storage=stores["jax"]).models[0]
        pm = prepare_deploy(instance_id=iid["port"], storage=stores["port"],
                            device="cpu").models[0]
        assert jm.user_ids.to_dict() == pm.user_ids.to_dict()
        assert jm.item_ids.to_dict() == pm.item_ids.to_dict()
        np.testing.assert_allclose(np.asarray(pm.U), np.asarray(jm.U), atol=1e-4)
        np.testing.assert_allclose(np.asarray(pm.V), np.asarray(jm.V), atol=1e-4)


# -- SIGKILL mid-delta-train through the port's CLI ----------------------------


def test_sigkill_mid_delta_train_resumes_and_promotes_once(tmp_path):
    home = tmp_path / "home"
    st = port_registry.Storage(port_registry.StorageConfig(home=str(home)))
    app = st.meta.create_app("CrashApp")
    st.events.init_channel(app.id)
    st.events.insert_batch([
        Event(event="rate", entity_type="user", entity_id=str(u),
              target_entity_type="item", target_entity_id=str(i),
              properties={"rating": 5.0 if (u % 2) == (i % 2) else 1.0})
        for u in range(24) for i in range(16) if (u + i) % 2 == 0], app.id)
    variant = {"id": "crash", "engineFactory": RECOMMENDATION_FACTORY,
               "datasource": {"params": {"appName": "CrashApp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 4, "numIterations": 400, "lambda": 0.05, "seed": 1,
                   "checkpointEvery": 1}}]}
    vpath = tmp_path / "variant.json"
    vpath.write_text(json.dumps(variant))
    env = {**os.environ, "PIO_HOME": str(home), "PYTHONPATH": REPO}
    argv = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "train",
            "--continuous", "--engine-dir", ENGINE_DIR, "-e", str(vpath),
            "--device", "cpu", "--max-cycles", "1", "--poll-interval", "0.2",
            "--lease-ttl", "1", "--no-incidents"]
    ckpt_root = home / "train_ckpt_torch"

    def steps():
        return [p for p in ckpt_root.rglob("*") if p.is_dir() and p.name.isdigit()] \
            if ckpt_root.is_dir() else []

    proc = subprocess.Popen(argv, cwd=str(tmp_path), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 120.0
    try:
        while len(steps()) < 2:
            assert proc.poll() is None, "trainer finished before the kill: " + \
                proc.stderr.read().decode()
            assert time.monotonic() < deadline, "no checkpoint progress"
            time.sleep(0.01)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    assert len(steps()) >= 2
    reg_path = home / "model_registry" / "registry.json"
    assert not reg_path.exists(), "the killed run must not have published"
    # the killed trainer never released its lease: wait out its TTL
    lease = json.loads((home / "trainer.lease").read_text())
    assert lease["token"] == 1 and lease["expires"] > 0
    time.sleep(max(0.0, lease["expires"] - time.time()) + 0.05)
    done = subprocess.run(argv, cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "[train] promoted gen=1" in done.stdout
    doc = json.loads(reg_path.read_text())
    assert doc["champion"] == 1 and len(doc["generations"]) == 1
    assert doc["fence_token"] == 2
    assert not steps()
    # the resumed train's factors equal a straight train's on the same data
    st2 = port_registry.Storage(port_registry.StorageConfig(home=str(home)))
    resumed = prepare_deploy(instance_id=doc["generations"][0]["instance_id"],
                             storage=st2, device="cpu").models[0]
    straight_id = run_train(RECOMMENDATION_FACTORY, variant=variant, storage=st2,
                            device="cpu")
    straight = prepare_deploy(instance_id=straight_id, storage=st2,
                              device="cpu").models[0]
    np.testing.assert_allclose(resumed.U, straight.U, atol=1e-6)
    np.testing.assert_allclose(resumed.V, straight.V, atol=1e-6)


# -- serving-metrics parsing and the metrics listener --------------------------


PROM_TEXTS = [
    ('# HELP x y\n'
     'pio_engine_queries_total{status="200"} 90\n'
     'pio_engine_queries_total{status="500"} 10\n'
     'pio_engine_query_seconds_bucket{status="200",le="0.05"} 50\n'
     'pio_engine_query_seconds_bucket{status="200",le="0.5"} 96\n'
     'pio_engine_query_seconds_bucket{status="200",le="+Inf"} 100\n'),
    ('pio_engine_queries_total{status="503",app="a\\"b"} 7\n'
     'pio_engine_query_seconds_bucket{le="0.01",status="200"} 3\n'
     'pio_engine_query_seconds_bucket{le="0.1",status="200"} 3\n'
     'pio_engine_query_seconds_bucket{le="+Inf",status="200"} 3\n'
     'garbage line\n'
     'pio_x NaN\n'
     'pio_y +Inf\n'),
    '',
]


@pytest.mark.parametrize("text", PROM_TEXTS)
def test_prom_parsing_matches_jax(text):
    jp, pp = jax_trainer._parse_prom(text), port_trainer._parse_prom(text)
    assert list(jp) == list(pp)
    assert all((math.isnan(jp[k]) and math.isnan(pp[k])) or jp[k] == pp[k] for k in jp)
    js, ps = jax_trainer._query_stats(jp), port_trainer._query_stats(pp)
    assert js == ps
    before = {le: c / 2 for le, c in js[2].items()}
    for b in ({}, before):
        assert jax_trainer._p95_from_delta(b, js[2]) == port_trainer._p95_from_delta(b, ps[2])
    if text == PROM_TEXTS[0]:
        assert port_trainer._p95_from_delta({}, ps[2]) == 0.5


@BOTH
def test_metrics_listener_serves_metrics_history_and_health(home_storage, pkg):
    import threading
    import urllib.request

    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), metrics_port=0)
    assert t.tsdb is not None
    t._start_listener()
    try:
        port = t.metrics_bound_port
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=5).read().decode()
        assert "pio_trainer_cycles_total" in body and "pio_trainer_lease_held" in body
        doc = json.load(urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                               timeout=5))
        assert doc["status"] == "ok" and doc["role"] == "trainer"
        assert doc["leaseHeld"] is False
        t.tsdb.record("pio_trainer_lease_held", {}, 1.0)
        hist = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics/history"
            "?series=pio_trainer_lease_held&window=15m", timeout=5))
        assert hist["windowSeconds"] == 900.0
        assert "pio_trainer_lease_held" in hist["series"]
    finally:
        t._stop_listener()
    assert t.metrics_bound_port is None
    assert not any(th.name == "trainer-metrics" for th in threading.enumerate())


@BOTH
def test_run_counts_cycles_and_stops_listener(home_storage, pkg):
    import threading

    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), metrics_port=0)
    outcomes = t.run(max_cycles=1, install_signals=False)
    assert len(outcomes) == 1
    out = outcomes[0]["outcome"]
    assert f'pio_trainer_cycles_total{{outcome="{out}"}}' in p.metrics.REGISTRY.render()
    assert t.metrics_bound_port is None
    assert not any(th.name == "trainer-metrics" for th in threading.enumerate())


def test_verbose_run_prints_one_line_a_cycle(tmp_path, capsys):
    """``cfg.verbose`` prints each cycle's outcome, step walls and the
    process's kernel launches, and a gated cycle's verdict (the lines
    chip_smoke.py reads)."""
    st = port_registry.Storage(port_registry.StorageConfig(
        metadata_type="MEMORY", eventdata_type="MEMORY", modeldata_type="MEMORY",
        home=str(tmp_path)))
    st._meta = port_meta.MetaStore(":memory:")
    st._events = port_events.MemoryEventStore()
    st._models = port_models.MemoryModelStore()
    _seed_events(PKG["port"], st)
    t = _trainer(PKG["port"], st, FakeClock(), min_delta_events=5, verbose=1)
    t.run(max_cycles=2, install_signals=False)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[trainer]")]
    assert lines[0].startswith("[trainer] cycle 1: promoted gen=1 train=")
    assert "gate=" in lines[0] and "reload=" in lines[0]
    assert "kernel launches: score_topk=" in lines[0]
    assert json.loads(lines[1][len("[trainer] gate: "):])["reason"] == \
        "no champion: first generation promotes"
    assert lines[2].startswith("[trainer] cycle 2: idle gen=None")
    assert len(lines) == 3


# -- a long-lived trainer over a log another process writes --------------------


_APPEND = """
import sys
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.filestore import NativeEventLogStore
st = NativeEventLogStore(sys.argv[1])
st.insert_batch([Event(event="rate", entity_type="user", entity_id=str(i % 4),
                       target_entity_type="item", target_entity_id=str(i % 3),
                       properties={"rating": 3.0}) for i in range(int(sys.argv[3]))],
                int(sys.argv[2]))
"""


def test_a_long_lived_trainer_wakes_on_another_process_appends(tmp_path):
    """An EVENTLOG home that another process appends to: a trainer that
    reads it through a ``LogView`` wakes on each delta (the view is
    refreshed at every wake), while one that opened the store itself
    stays idle after its first read; neither cuts the writer's file."""
    import subprocess
    import sys

    from predictionio_tpu_torch.data.replication import LogView

    home = str(tmp_path / "home")
    config = port_registry.StorageConfig(home=home, eventdata_type="EVENTLOG")
    app = port_registry.Storage(config).meta.create_app("LoopApp")
    log_dir = os.path.join(home, "eventlog")

    def append(n):
        subprocess.run([sys.executable, "-c", _APPEND, log_dir, str(app.id), str(n)],
                       check=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})

    append(12)
    trainers = {}
    for name in ("view", "opened"):
        st = (port_registry.Storage(config, events=LogView(home)) if name == "view"
              else port_registry.Storage(config))
        trainers[name] = _trainer(PKG["port"], st, FakeClock(), min_delta_events=5,
                                  lease_path=os.path.join(home, f"{name}.lease"))
        trainers[name].state_path = os.path.join(home, f"{name}.state.json")
        assert trainers[name].run_once()["outcome"] == "promoted"
        assert trainers[name].run_once()["outcome"] == "idle"
    append(6)
    size = os.path.getsize(os.path.join(log_dir, f"events_{app.id}.pel"))
    assert trainers["view"].run_once()["outcome"] == "promoted"
    assert trainers["opened"].run_once()["outcome"] == "idle"
    assert json.load(open(os.path.join(home, "view.state.json")))["count"] == 18
    assert os.path.getsize(os.path.join(log_dir, f"events_{app.id}.pel")) == size
    trainers["view"].storage.events.close()


@BOTH
def test_a_candidate_whose_every_query_fails(home_storage, pkg, monkeypatch):
    """The offline gate on a candidate that materialises but raises on
    every query: the port refuses it, the JAX package passes it as
    unscoreable."""
    p = PKG[pkg]
    _seed_events(p, home_storage)
    t = _trainer(p, home_storage, FakeClock(), min_delta_events=5,
                 guardrail_min_events=1)
    assert t.run_once()["outcome"] == "promoted"
    champion = t.registry.champion()["instance_id"]

    class Deployed:
        def __init__(self, ok):
            self.ok = ok

        def query(self, q):
            if not self.ok:
                raise RuntimeError("broken candidate")
            return {"itemScores": [{"item": q["item"], "score": 3.0}]}

    workflow = ("predictionio_tpu_torch" if pkg == "port" else "predictionio_tpu") \
        + ".core.workflow.prepare_deploy"
    monkeypatch.setattr(workflow, lambda instance_id=None, storage=None, **_kw:
                        Deployed(instance_id == champion))
    _more(p, home_storage, "9", 5.0, n=6)
    rec = t.run_once()
    if pkg == "port":
        assert (rec["outcome"], rec["generation"]) == ("refused", 2)
        assert rec["detail"]["reason"].startswith("all ") and \
            rec["detail"]["champion_rmse"] is not None
    else:
        assert rec["outcome"] == "promoted"
        assert rec["detail"]["gate"]["reason"] == "unscoreable: pass"
