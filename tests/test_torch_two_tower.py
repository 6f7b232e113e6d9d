"""The port's two-tower model and template held against the JAX
package's, on the CPU.

- weights carried from flax (``two_tower_variables_from_jax``) give the
  JAX towers' embeddings, and go back to flax dicts bit for bit;
- two epochs from carried weights stay within 1e-4 of each parameter's
  max |value| of the JAX training (optax ``adam`` against
  ``torch.optim.Adam``: one formula, other rounding), in memory and
  streaming (the ``(G, B)`` groups with carried remainders);
- a run resumed from its mid-train checkpoint equals the straight run
  bit for bit; the resuming run's learning rate wins; a checkpoint of
  another geometry is wiped with a warning;
- on one home both packages train the template (exact, plain PQ and
  OPQ); each package serves each instance (the blobs load both ways)
  with the same answers, up to near-ties within 1e-5, and ``[]`` for an
  unknown user, through ``query`` and ``batch_query``;
- the blob's params dataclass is named by its JAX module path both ways;
- ``pio eval`` Recall@10 with ``DefaultGrid`` and ``ANNGrid`` equals the
  JAX package's when the port starts from the JAX package's initial
  weights (the packages draw them from different generators);
- the streaming path's ``DevicePrefetcher`` hands out the JAX package's
  items in its order on the CPU, runs ahead, re-raises the source's
  error and stops its thread on close.

Data crosses between the packages as numpy arrays, SQLite rows and
pickled blobs.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.models import two_tower as jax_tt
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.twotower import engine as jax_engine
from predictionio_tpu_torch.core.workflow import (
    JAX_TWOTOWER_FACTORY,
    TWOTOWER_FACTORY,
    prepare_deploy,
    run_evaluation,
    run_train,
)
from predictionio_tpu_torch.models import two_tower as port_tt
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.twotower import engine as port_engine

TOL = 1e-4         # trained parameters, of each one's max |value|
ANSWER_TOL = 1e-5  # answers: scores, and the width of a near-tie
N_USERS, N_ITEMS = 60, 40


def _pairs(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_USERS, n).astype(np.int32),
            rng.integers(0, N_ITEMS, n).astype(np.int32))


def jax_init(n_users, n_items, p):
    """The JAX package's initial (user, item) variables for ``p``'s
    geometry and seed, drawn as its ``two_tower_train`` draws them."""
    ut, it = jax_tt._towers(n_users, n_items, p)
    ru, ri = jax.random.split(jax.random.PRNGKey(p.seed))
    return (jax.tree.map(np.asarray, ut.init(ru, jnp.zeros((1,), jnp.int32))),
            jax.tree.map(np.asarray, it.init(ri, jnp.zeros((1,), jnp.int32))))


def _params(pkg, **kw):
    base = dict(embed_dim=8, hidden=[16], out_dim=8, batch_size=128, epochs=2,
                learning_rate=0.01, temperature=0.1, seed=0)
    base.update(kw)
    return (jax_tt if pkg == "jax" else port_tt).TwoTowerParams(**base)


def _rel(a, b):
    """Worst |a - b| / max|a| over every leaf of two flax dicts."""
    return max(float(np.abs(np.asarray(a["params"][k][kk]) - np.asarray(b["params"][k][kk])).max()
                     / np.abs(np.asarray(a["params"][k][kk])).max())
               for k in a["params"] for kk in a["params"][k])


def _bitwise(a, b):
    return all(np.array_equal(np.asarray(a["params"][k][kk]), np.asarray(b["params"][k][kk]))
               for k in a["params"] for kk in a["params"][k])


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("hidden", [[16], [], [16, 12]])
def test_carried_weights_give_equal_embeddings(hidden):
    p = _params("jax", hidden=hidden)
    uv, iv = jax_init(N_USERS, N_ITEMS, p)
    user, item = port_tt.two_tower_variables_from_jax(uv, iv)
    ut, it = jax_tt._towers(N_USERS, N_ITEMS, p)
    for tower, jt, vars_, n in ((user, ut, uv, N_USERS), (item, it, iv, N_ITEMS)):
        ids = np.arange(n)
        want = np.asarray(jt.apply(vars_, jnp.asarray(ids, jnp.int32)))
        got = tower(torch.from_numpy(ids)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(port_tt._tower_forward_np(vars_, ids),
                                      jax_tt._tower_forward_np(vars_, ids))
    back_u, back_i = port_tt.two_tower_variables_to_jax(user, item)
    assert _bitwise(back_u, uv) and _bitwise(back_i, iv)
    assert set(back_u["params"]) == set(uv["params"])
    # the port's own seeded init has flax's shapes
    pu, pi = port_tt.init_variables(N_USERS, N_ITEMS, _params("port", hidden=hidden))
    assert {k: {kk: v.shape for kk, v in d.items()} for k, d in pu["params"].items()} == \
        {k: {kk: np.shape(v) for kk, v in d.items()} for k, d in uv["params"].items()}


@pytest.mark.parametrize("stream", [None, (3000, 700, 64), (140_000, 50_000, 1024)])
def test_two_epochs_within_tolerance_of_jax(stream):
    """Streaming: (pairs, chunk, batch). 3,000 pairs in chunks of 700 at
    batch 64 never fill a (G, B) group, so every step is a carried tail
    step; 140,000 in chunks of 50,000 at batch 1,024 (G = 64) train whole
    groups with remainders carried across chunks, then the tail."""
    u, i = _pairs(stream[0] if stream else 3000)
    jp, pp = _params("jax", n_pairs=len(u)), _params("port", n_pairs=len(u))
    init = jax_init(N_USERS, N_ITEMS, jp)
    if stream:
        _, chunk, jp.batch_size = stream
        pp.batch_size = jp.batch_size

        def chunks():
            for lo in range(0, len(u), chunk):
                yield u[lo:lo + chunk], i[lo:lo + chunk], np.ones(len(u[lo:lo + chunk]),
                                                                  np.float32)

        empty = np.zeros(0, np.int32)
        jv = jax_tt.two_tower_train(empty, empty, N_USERS, N_ITEMS, jp, pair_chunks=chunks)
        stats = {}
        pv = port_tt.two_tower_train(empty, empty, N_USERS, N_ITEMS, pp, pair_chunks=chunks,
                                     device="cpu", initial_variables=init, stats=stats)
        assert stats["steps"] == 2 * (len(u) // pp.batch_size)
    else:
        jv = jax_tt.two_tower_train(u, i, N_USERS, N_ITEMS, jp)
        pv = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS, pp, device="cpu",
                                     initial_variables=init)
    for j, p in zip(jv, pv):
        assert _rel(j, p) <= TOL


def test_training_needs_two_pairs_and_a_card():
    p = _params("port")
    with pytest.raises(ValueError, match="at least 2"):
        port_tt.two_tower_train(np.zeros(1, np.int32), np.zeros(1, np.int32), 2, 2, p,
                                device="cpu")
    u, i = _pairs(100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tt.two_tower_train(u, i, N_USERS, N_ITEMS, p)


def test_resume_is_bitwise_the_straight_run_and_this_runs_lr_wins(tmp_path):
    u, i = _pairs()
    straight = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS, _params("port", epochs=3),
                                       device="cpu")
    ck = str(tmp_path / "ck")
    port_tt.two_tower_train(u, i, N_USERS, N_ITEMS,
                            _params("port", epochs=2, checkpoint_dir=ck), device="cpu")
    assert sorted(os.listdir(ck)) == ["1", "2"]
    stats = {}
    resumed = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS,
                                      _params("port", epochs=3, checkpoint_dir=ck),
                                      device="cpu", stats=stats)
    assert stats["steps"] == len(u) // 128    # one epoch ran
    assert all(_bitwise(a, b) for a, b in zip(straight, resumed))
    # resumed from epoch 2 at lr 0: this run's rate wins, nothing moves
    ck2 = str(tmp_path / "ck2")
    two = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS,
                                  _params("port", epochs=2, checkpoint_dir=ck2), device="cpu")
    frozen = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS,
                                     _params("port", epochs=3, learning_rate=0.0,
                                             checkpoint_dir=ck2), device="cpu")
    assert all(_bitwise(a, b) for a, b in zip(two, frozen))
    # another geometry: the stale checkpoints are wiped, training starts over
    with pytest.warns(RuntimeWarning, match="stale"):
        wide = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS,
                                       _params("port", epochs=1, embed_dim=12,
                                               checkpoint_dir=ck2), device="cpu")
    fresh = port_tt.two_tower_train(u, i, N_USERS, N_ITEMS,
                                    _params("port", epochs=1, embed_dim=12), device="cpu")
    assert all(_bitwise(a, b) for a, b in zip(wide, fresh))


# -- the template on twin homes ------------------------------------------------


VARIANTS = {
    "exact": {},
    "pq": {"ann": True, "annM": 4, "annK": 16, "annIters": 2, "annShortlist": 16,
           "annSample": 512},
    "opq": {"ann": True, "annM": 4, "annK": 16, "annIters": 2, "annShortlist": 16,
            "annSample": 512, "annOpq": True},
}


def _variant(factory, kind):
    algo = {"embedDim": 16, "outDim": 16, "hidden": [32], "epochs": 3, "batchSize": 128,
            **VARIANTS[kind]}
    return {"id": kind, "engineFactory": factory,
            "datasource": {"params": {"appName": "TTApp"}},
            "algorithms": [{"name": "twotower", "params": algo}]}


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """An app of 400 views (20 users × 16 items); each package's instance
    of each variant."""
    home = str(tmp_path_factory.mktemp("pio_twotower"))
    js = JaxStorage(JaxStorageConfig(home=home))
    app = js.meta.create_app("TTApp")
    js.events.init_channel(app.id)
    rng = np.random.default_rng(11)
    js.events.insert_batch([
        JaxEvent(event="view", entity_type="user", entity_id=f"u{int(u)}",
                 target_entity_type="item", target_entity_id=f"i{int(i)}")
        for u, i in zip(rng.integers(0, 20, 400), rng.integers(0, 16, 400))], app.id)
    ps = Storage(StorageConfig(home=home))
    ids = {}
    for kind in VARIANTS:
        ids[kind, "jax"] = jax_run_train(JAX_TWOTOWER_FACTORY,
                                         variant=_variant(JAX_TWOTOWER_FACTORY, kind),
                                         storage=js, use_mesh=False)
        ids[kind, "port"] = run_train(TWOTOWER_FACTORY,
                                      variant=_variant(TWOTOWER_FACTORY, kind),
                                      storage=ps, device="cpu")
    return home, ids


def _agree(a, b):
    """Two answers equal up to near-ties: the same length, scores within
    ANSWER_TOL position by position, items equal where the scores are not
    tied."""
    sa, sb = a["itemScores"], b["itemScores"]
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert abs(x["score"] - y["score"]) <= ANSWER_TOL
    assert {x["item"] for x in sa if abs(x["score"] - sa[-1]["score"]) > ANSWER_TOL} == \
        {y["item"] for y in sb if abs(y["score"] - sb[-1]["score"]) > ANSWER_TOL}


QUERIES = [{"user": "u1", "num": 5}, {"user": "u2", "num": 3}, {"user": "u7", "num": 16},
           {"user": "u19", "num": 40}, {"user": "nobody", "num": 3}]


@pytest.mark.parametrize("kind", list(VARIANTS))
@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_each_package_serves_each_instance_alike(home, kind, trained_by, monkeypatch):
    from predictionio_tpu_torch.ann import ANNScorer
    from predictionio_tpu_torch.models.als import ResidentScorer
    from predictionio_tpu_torch.server.aot import PAD

    home, ids = home
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    iid = ids[kind, trained_by]
    jd = jax_prepare_deploy(instance_id=iid, storage=JaxStorage(JaxStorageConfig(home=home)))
    pd = prepare_deploy(instance_id=iid, storage=Storage(StorageConfig(home=home)),
                        device="cpu")
    model = pd.models[0]
    assert isinstance(model._device_scorer(),
                      ResidentScorer if kind == "exact" else ANNScorer)
    assert (model.ann_index is not None) == (kind != "exact")
    if kind == "opq":
        assert model.ann_index.rotation is not None
    for q in QUERIES:
        _agree(pd.query(q), jd.query(q))
    assert pd.query({"user": "nobody", "num": 3}) == {"itemScores": []}
    batch = pd.batch_query([QUERIES[0], PAD, QUERIES[4], QUERIES[2]])
    assert batch[1] is PAD
    for got, q in zip([batch[0], batch[2], batch[3]], [QUERIES[0], QUERIES[4], QUERIES[2]]):
        _agree(got, jd.query(q))
    monkeypatch.setenv("PIO_ALS_SERVE", "host")
    host = prepare_deploy(instance_id=iid, storage=Storage(StorageConfig(home=home)),
                          device="cpu")
    assert host.models[0]._device_scorer() is None
    if kind == "exact":
        for q in QUERIES:
            _agree(host.query(q), pd.query(q))


def test_blob_params_cross_both_ways_and_sharding_refused(home, tmp_path):
    home, ids = home
    ps = Storage(StorageConfig(home=home))
    js = JaxStorage(JaxStorageConfig(home=home))
    port_blob = pickle.loads(ps.models.get(ids["pq", "port"]))[0]
    jax_blob = pickle.loads(js.models.get(ids["pq", "jax"]))[0]
    d = pickle.loads(port_blob)               # the JAX package's own unpickler
    assert type(d["params"]) is jax_tt.TwoTowerParams and d["params"].embed_dim == 16
    assert isinstance(d["ann_index"], bytes) and d["ann_index"][:8] == b"PIOANN01"
    assert type(port_engine.loads_blob(jax_blob)["params"]) is port_tt.TwoTowerParams
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        port_engine.loads_blob(pickle.dumps(jax_engine.TTAlgorithmParams()))
    algo = port_engine.TwoTowerAlgorithm(port_engine.TTAlgorithmParams())
    algo.device = "cpu"
    # the blob's own index bytes serve when there is no sidecar
    model = algo.load_model(port_blob, None)
    assert model.ann_index is not None and model.user_embeds.shape == (20, 16)
    with pytest.raises(ValueError, match="item 8"):
        algo.load_model(port_engine.dumps_blob(dict(port_engine.loads_blob(port_blob),
                                                    ann_shards=2)), None)
    with pytest.raises(ValueError, match="item 8"):
        port_engine.TwoTowerAlgorithm(port_engine.TTAlgorithmParams(
            ann=True, ann_shards=2)).train(None, None)


# -- pio eval -----------------------------------------------------------------


@pytest.mark.parametrize("grid", ["DefaultGrid", "ANNGrid"])
def test_pio_eval_recall_equals_the_jax_packages(home, grid, monkeypatch):
    home, _ = home
    monkeypatch.setenv("PIO_EVAL_APP_NAME", "TTApp")
    monkeypatch.setenv("PIO_EVAL_ANN_SHORTLISTS", "8,16")
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    monkeypatch.setattr(port_tt, "init_variables", jax_init)
    js, ps = JaxStorage(JaxStorageConfig(home=home)), Storage(StorageConfig(home=home))
    jax_registry.set_storage(js)
    port_registry.set_storage(ps)
    try:
        _, jres = jax_run_evaluation(jax_engine.TTEvaluation(),
                                     getattr(jax_engine, grid)().engine_params_list,
                                     storage=js, use_mesh=False)
        _, pres = run_evaluation(port_engine.TTEvaluation(),
                                 getattr(port_engine, grid)().engine_params_list,
                                 storage=ps, device="cpu")
    finally:
        jax_registry.set_storage(None)
        port_registry.set_storage(None)
    assert port_engine.TTEvaluation.metric.header == "Recall@10"
    assert [s for _, s, _ in pres.candidates] == [s for _, s, _ in jres.candidates]
    assert pres.best_index == jres.best_index


# -- the streaming path's prefetcher ------------------------------------------


@pytest.mark.parametrize("tupled", [False, True])
def test_prefetcher_hands_out_the_jax_prefetchers_items_in_order(tupled):
    """On the CPU the port's prefetcher passes the host arrays through,
    in the order and with the values the JAX package's hands out."""
    from predictionio_tpu.data.pipeline import DevicePrefetcher as JaxPrefetcher
    from predictionio_tpu_torch.data.pipeline import DevicePrefetcher

    def source():
        rng = np.random.default_rng(5)
        for _ in range(7):
            a = rng.integers(0, 100, (3, 4)).astype(np.int32)
            yield (a, a + 1) if tupled else a

    with JaxPrefetcher(source()) as pf:
        want = [jax.tree_util.tree_map(np.asarray, x) for x in pf]
    with DevicePrefetcher(source(), device="cpu") as pf:
        got = list(pf)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        g, w = (g, w) if tupled else ((g,), (w,))
        for ga, wa in zip(g, w):
            assert isinstance(ga, np.ndarray)
            np.testing.assert_array_equal(ga, wa)


def test_prefetcher_runs_ahead_reraises_and_stops():
    import time

    from predictionio_tpu_torch.data.pipeline import PREFETCH_DEPTH, DevicePrefetcher

    produced = []

    def slow_source():
        for k in range(4):
            produced.append(k)
            yield np.asarray([k])

    with DevicePrefetcher(slow_source(), device="cpu") as pf:
        first = next(pf)
        time.sleep(0.3)  # the consumer computes; the producer runs ahead
        assert len(produced) >= PREFETCH_DEPTH
        rest = list(pf)
    assert int(first[0]) == 0 and [int(a[0]) for a in rest] == [1, 2, 3]

    def bad_source():
        yield np.asarray([1])
        raise RuntimeError("source broke")

    pf = DevicePrefetcher(bad_source(), device="cpu")
    assert int(next(pf)[0]) == 1
    with pytest.raises(RuntimeError, match="source broke"):
        next(pf)
    pf.close()

    def infinite():
        k = 0
        while True:
            yield np.asarray([k])
            k += 1

    pf = DevicePrefetcher(infinite(), device="cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
