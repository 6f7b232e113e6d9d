"""``pio train`` in the port held against the JAX package's, on the CPU.

Events are seeded with ``tests/test_workflow.seed_ratings`` through the
JAX package's storage into a temporary PIO_HOME (SQLite meta and events,
LOCALFS models); no test here touches the default home. On that home:

- the port's ``RecDataSource.read_training`` gives the JAX one's
  ``TrainingData``: the same arrays, bitwise, and the same id maps;
- the port's ``run_train(device="cpu")`` and its CLI ``train --device
  cpu`` write COMPLETED instances whose factors equal the JAX
  ``run_train(use_mesh=False)`` ones within rtol/atol 1e-4 (f32 solves in
  another order, eight iterations) and whose params JSON is the JAX
  package's, byte for byte;
- the port's instance deploys in both packages with equal answers;
- without a card and without a CPU request, training raises.

The self-cleaning window is held against the JAX package's with the
clock pinned (``now=``). Data crosses between the packages as numpy
arrays, bytes and SQLite rows.
"""

import datetime as dt
import json
import os
import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.base import WorkflowContext as JaxWorkflowContext
from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.cleaning import EventWindow as JaxEventWindow
from predictionio_tpu.data.cleaning import clean_persisted_events as jax_clean
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.core.workflow import (
    RECOMMENDATION_FACTORY,
    prepare_deploy,
    run_train,
)
from predictionio_tpu_torch.data.cleaning import EventWindow, clean_persisted_events
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.store import find
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.recommendation import engine as port_rec
from predictionio_tpu_torch.tools import cli
from tests.test_workflow import FACTORY, VARIANT, seed_ratings

TOL = 1e-4
PORT_VARIANT = dict(VARIANT, engineFactory=RECOMMENDATION_FACTORY)
USERS = [str(u) for u in range(30)] + ["no-such-user"]


def _jax_storage(home):
    return JaxStorage(JaxStorageConfig(home=home))


def _port_storage(home):
    return Storage(StorageConfig(home=home))


def _factors(storage, instance_id, algo):
    blob = pickle.loads(storage.models.get(instance_id))[0]
    return algo.load_model(blob, None)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    home = str(tmp_path_factory.mktemp("pio_home"))
    seed_ratings(_jax_storage(home))
    return home


@pytest.fixture(scope="module")
def trained(home):
    """(JAX instance id, port instance id), both trained on ``home``, the
    port's second."""
    jid = jax_run_train(FACTORY, variant=VARIANT, storage=_jax_storage(home),
                        use_mesh=False)
    pid = run_train(RECOMMENDATION_FACTORY, variant=PORT_VARIANT,
                    storage=_port_storage(home), device="cpu")
    return jid, pid


def test_read_training_matches_jax(home):
    theirs = jax_rec.RecDataSource(jax_rec.DataSourceParams(app_name="TestApp")) \
        .read_training(JaxWorkflowContext(storage=_jax_storage(home)))
    mine = port_rec.RecDataSource(port_rec.DataSourceParams(app_name="TestApp")) \
        .read_training(WorkflowContext(storage=_port_storage(home)))
    assert mine.n == theirs.n > 0
    for name in ("user_idx", "item_idx", "rating"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine.user_ids.to_dict() == theirs.user_ids.to_dict()
    assert mine.item_ids.to_dict() == theirs.item_ids.to_dict()
    # the implicit "buy" event is read at buy_rating
    assert 4.0 in set(mine.rating.tolist())


def test_run_train_matches_jax(home, trained):
    jid, pid = trained
    pst = _port_storage(home)
    ei, jei = pst.meta.get_engine_instance(pid), pst.meta.get_engine_instance(jid)
    assert ei.status == jei.status == "COMPLETED"
    assert ei.engine_factory == FACTORY  # the name both packages know
    for field in ("data_source_params", "preparator_params",
                  "algorithms_params", "serving_params", "engine_variant"):
        assert getattr(ei, field) == getattr(jei, field), field
    mine = _factors(pst, pid, port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams()))
    theirs = _factors(_jax_storage(home), jid,
                      jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams()))
    assert mine.user_ids.to_dict() == theirs.user_ids.to_dict()
    assert mine.item_ids.to_dict() == theirs.item_ids.to_dict()
    np.testing.assert_allclose(mine.U, theirs.U, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mine.V, theirs.V, rtol=TOL, atol=TOL)


def test_port_instance_deploys_in_both_packages(home, trained):
    _, pid = trained
    # each package finds it under the factory it knows
    theirs = jax_prepare_deploy(FACTORY, storage=_jax_storage(home),
                                variant_id="default")
    mine = prepare_deploy(RECOMMENDATION_FACTORY, storage=_port_storage(home),
                          variant_id="default", device="cpu")
    assert theirs.instance.id == mine.instance.id == pid
    for user in USERS:
        for num in (1, 5):
            a = mine.query({"user": user, "num": num})
            b = theirs.query({"user": user, "num": num})
            assert [s["item"] for s in a["itemScores"]] == \
                [s["item"] for s in b["itemScores"]]
            np.testing.assert_allclose([s["score"] for s in a["itemScores"]],
                                       [s["score"] for s in b["itemScores"]],
                                       rtol=1e-6)


def test_cli_train_writes_a_completed_instance(home, trained, tmp_path, monkeypatch):
    jid, _ = trained
    variant = tmp_path / "engine.json"
    variant.write_text(json.dumps(PORT_VARIANT))
    monkeypatch.setenv("PIO_HOME", home)
    port_registry.set_storage(_port_storage(home))
    try:
        cli.main(["train", "--engine-dir", str(tmp_path), "--device", "cpu",
                  "--batch", "cli"])
    finally:
        port_registry.set_storage(None)
    pst = _port_storage(home)
    ei = pst.meta.get_latest_completed_engine_instance(FACTORY, "default")
    assert ei.batch == "cli" and ei.status == "COMPLETED"
    mine = _factors(pst, ei.id, port_rec.ALSAlgorithm(port_rec.ALSAlgorithmParams()))
    theirs = _factors(_jax_storage(home), jid,
                      jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams()))
    np.testing.assert_allclose(mine.U, theirs.U, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mine.V, theirs.V, rtol=TOL, atol=TOL)


def test_train_without_card_or_cpu_request_raises(home, trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pst = _port_storage(home)
    before = pst.meta.get_latest_completed_engine_instance(FACTORY).id
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(RECOMMENDATION_FACTORY, variant=PORT_VARIANT, storage=pst)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--engine-dir",
                  os.path.join(os.path.dirname(os.path.dirname(__file__)),
                               "predictionio_tpu_torch", "templates", "recommendation")])
    # it raised before writing any instance
    assert pst.meta.get_latest_completed_engine_instance(FACTORY).id == before


def test_failed_train_is_recorded(tmp_path):
    pst = _port_storage(str(tmp_path))
    pst.meta.create_app("TestApp")  # an app with no events
    with pytest.raises(ValueError, match="no rate/buy events"):
        run_train(RECOMMENDATION_FACTORY, variant=PORT_VARIANT, storage=pst,
                  device="cpu")
    row = pst.meta._q1("SELECT status FROM engine_instances")
    assert row == ("FAILED",)


def test_event_stores_read_each_others_events(tmp_path):
    home = str(tmp_path)
    jst, pst = _jax_storage(home), _port_storage(home)
    japp = jst.meta.create_app("A")
    assert pst.meta.get_app_by_name("A").id == japp.id
    papp = pst.meta.create_app("B")
    assert jst.meta.get_app_by_name("B").id == papp.id
    t = dt.datetime(2026, 1, 2, 3, 4, 5, 678000, tzinfo=dt.timezone.utc)
    kw = dict(entity_type="user", entity_id="u1", target_entity_type="item",
              target_entity_id="i9", properties={"rating": 4.5}, event_time=t,
              tags=["x"], creation_time=t)
    jst.events.insert_batch([JaxEvent(event="rate", **kw)], japp.id)
    pst.events.insert_batch([Event(event="buy", **kw)], papp.id)
    for app, name in ((japp.id, "rate"), (papp.id, "buy")):
        mine = [e.to_json() for e in pst.events.find(app)]
        theirs = [e.to_json() for e in jst.events.find(app)]
        assert mine == theirs and len(mine) == 1 and mine[0]["event"] == name
    # a channel the JAX package made is read by name; a key the port
    # made is the JAX package's
    ch = jst.meta.create_channel(japp.id, "c1")
    jst.events.insert_batch([JaxEvent(event="view", **kw)], japp.id, ch.id)
    got = list(find("A", "c1", storage=pst))
    assert [e.event for e in got] == ["view"]
    key = pst.meta.create_access_key(papp.id, events=["buy"])
    assert jst.meta.get_access_key(key.key).events == ["buy"]
    with pytest.raises(ValueError, match="Channel 'c2' does not exist"):
        find("A", "c2", storage=pst)


def test_event_window_cleans_like_jax(tmp_path):
    now = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    rows = [("rate", "u1", "i1", {"rating": 3}, 40), ("rate", "u1", "i2", {"rating": 5}, 2),
            ("$set", "u1", None, {"a": 1}, 50), ("$set", "u1", None, {"b": 2}, 45),
            ("rate", "u2", "i1", {"rating": 4}, 1), ("rate", "u2", "i1", {"rating": 4}, 1)]
    results = []
    for pkg, ev_cls, clean, window in (
            ("jax", JaxEvent, jax_clean, JaxEventWindow(duration="30 days",
                                                        remove_duplicates=True,
                                                        compress_properties=True)),
            ("port", Event, clean_persisted_events,
             EventWindow(duration="30 days", remove_duplicates=True,
                         compress_properties=True))):
        home = str(tmp_path / pkg)
        st = _jax_storage(home) if pkg == "jax" else _port_storage(home)
        app = st.meta.create_app("W")
        st.events.insert_batch([
            ev_cls(event=n, entity_type="user", entity_id=e,
                   target_entity_type="item" if tgt else None, target_entity_id=tgt,
                   properties=p, event_time=now - dt.timedelta(days=d),
                   creation_time=now) for n, e, tgt, p, d in rows], app.id)
        stats = clean("W", window, storage=st, now=now)
        left = sorted((e.event, e.entity_id, e.target_entity_id,
                       json.dumps(e.properties, sort_keys=True), e.event_time)
                      for e in st.events.find(app.id))
        results.append((stats, left))
    assert results[0] == results[1]
    # one old rate dropped, two old $set folded into one, one re-send dropped
    assert results[1][0] == {"kept": 3, "dropped": 3, "compacted": 1}


def test_memory_event_store_reads_like_sqlite(tmp_path):
    from predictionio_tpu_torch.data.store import read_training_interactions

    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    events = [Event(event=n, entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=p, event_time=t0 + dt.timedelta(seconds=s))
              for s, (n, u, i, p) in enumerate([
                  ("rate", 1, 2, {"rating": 4}), ("rate", 2, 2, {"rating": "3.5"}),
                  ("buy", 1, 3, {}), ("rate", 3, 1, {"rating": "bad"}),
                  ("view", 2, 9, {}), ("rate", 2, 1, {"rating": 1.0})])]
    reads = []
    for cfg in (StorageConfig(home=str(tmp_path)),
                StorageConfig(home=str(tmp_path / "m"), metadata_type="MEMORY",
                              eventdata_type="MEMORY")):
        st = Storage(cfg)
        app = st.meta.create_app("M")
        st.events.insert_batch(events, app.id)
        data = read_training_interactions(
            "M", entity_type="user", target_entity_type="item",
            event_names=["rate", "buy"], value_key="rating",
            value_spec={"rate": "prop"}, default_spec=4.0, storage=st)
        reads.append((data.arrays(), data.user_ids.to_dict(), data.item_ids.to_dict()))
    (arrays, users, items), (m_arrays, m_users, m_items) = reads
    for a, b in zip(arrays, m_arrays):
        np.testing.assert_array_equal(a, b)
    assert users == m_users == {"u1": 0, "u2": 1}  # "bad" rating: event dropped
    assert items == m_items == {"i2": 0, "i3": 1, "i1": 2}
    np.testing.assert_array_equal(arrays[2], np.asarray([4.0, 3.5, 4.0, 1.0], np.float32))
