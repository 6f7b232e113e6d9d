"""The port's sequential recommender (SASRec-style) and its template held
against the JAX package's, on the CPU.

- ``init_params`` and ``make_training_batches`` are copies: bitwise the
  same weights and batches from the same seed;
- ``attention_reference`` within 1e-6 of the JAX package's, fully masked
  (left-padded) rows exactly zero; ``ring_attention`` is it for no mesh
  or a one-device axis and within 1e-6 of it over two slots;
- the forward pass and the loss within 1e-5, with l2 on and off, and
  every gradient within 1e-4 of its leaf's max |value|;
- three Adam steps, each taken by both packages from the same optax
  state, within 1e-5 of each leaf's max |value| (the port's ``Adam`` is
  ``inject_hyperparams(adam)`` with its f32 hyperparameters);
- over a mesh of 2 and 4 CPU slots (attention as ring attention over
  the slots) the forward pass, the loss and the gradients, three Adam
  steps and a whole run stay within the same tolerances of the JAX
  package's over as many devices; a mesh whose axis does not divide
  ``seq_len``, or that lacks the axis, trains with local attention;
- a run resumed from its mid-train checkpoint equals the straight run
  bit for bit, the resuming run's learning rate wins, a checkpoint of
  another geometry is wiped with a warning;
- ``seq_rec_scores`` within 1e-5, PAD at ``-inf``;
- on one home both packages train the template; each package serves
  each instance (the blobs cross both ways) with the same answers on
  ``history`` and on ``user`` (live history through the event store), up
  to near-ties; ``pio eval``'s leave-one-out hit rate is equal.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.models import seq_rec as jax_sr
from predictionio_tpu.parallel.ring_attention import attention_reference as jax_attention
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.sequentialrec import engine as jax_engine
from predictionio_tpu_torch.core.workflow import (
    JAX_SEQUENTIALREC_FACTORY,
    SEQUENTIALREC_FACTORY,
    prepare_deploy,
    run_evaluation,
    run_train,
)
from predictionio_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from predictionio_tpu_torch.models import seq_rec as port_sr
from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from predictionio_tpu_torch.parallel.ring_attention import (
    attention_reference as port_attention,
)
from predictionio_tpu_torch.parallel.ring_attention import ring_attention as port_ring
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.sequentialrec import engine as port_engine

ATT_TOL = 1e-6     # attention outputs, absolute
FWD_TOL = 1e-5     # forward states and the loss, absolute
GRAD_TOL = 1e-4    # gradients, of each leaf's max |value|
STEP_TOL = 1e-5    # parameters after an Adam step, of each leaf's max |value|
SCORE_TOL = 1e-5   # scores; and the width of a near-tie
N_ITEMS = 50


def _params(pkg, **kw):
    base = dict(hidden=16, num_blocks=2, num_heads=2, seq_len=12, batch_size=16,
                epochs=2, lr=1e-3, seed=7)
    base.update(kw)
    return (jax_sr if pkg == "jax" else port_sr).SeqRecParams(**base)


def _sequences(seed=0, n=70, n_items=N_ITEMS):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, n_items + 1, rng.integers(1, 30))]
            for _ in range(n)]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _rel(a, b):
    """Worst |a - b| / max|a| over the leaves of two pytrees / lists."""
    return max(float(np.abs(x - y).max() / max(np.abs(x).max(), 1e-30))
               for x, y in zip(a, b))


def _net(params, p):
    return port_sr.seq_rec_params_from_jax(params, p)


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("geom", [dict(), dict(hidden=8, num_blocks=0, seq_len=5),
                                  dict(num_blocks=3, num_heads=4, batch_size=128)])
def test_init_and_batches_are_bitwise_the_jax_packages(geom):
    jp, pp = _params("jax", **geom), _params("port", **geom)
    a, b = jax_sr.init_params(N_ITEMS, jp), port_sr.init_params(N_ITEMS, pp)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for seed in (0, 7):
        for x, y in zip(jax_sr.make_training_batches(_sequences(), jp, seed),
                        port_sr.make_training_batches(_sequences(), pp, seed)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    # the weights cross to the port's module and back bit for bit
    back = port_sr.seq_rec_params_to_jax(_net(a, pp))
    assert jax.tree.structure(back) == jax.tree.structure(a)
    for x, y in zip(_leaves(a), _leaves(back)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="no trainable"):
        port_sr.make_training_batches([[1], [], [0, 3]], pp)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_within_1e6_with_masked_rows_zero(causal):
    rng = np.random.default_rng(1)
    B, S, H, D = 3, 10, 2, 8
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    k_mask = np.ones((B, S), bool)
    k_mask[0, :4] = False        # left padding
    k_mask[2, :] = False         # every key masked
    want = np.asarray(jax_attention(q, k, v, causal=causal, k_mask=jnp.asarray(k_mask)))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = port_attention(*t, causal=causal, k_mask=torch.from_numpy(k_mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATT_TOL)
    assert (got[2] == 0).all()
    if causal:   # a query that sees only padded keys gets zeros
        assert (got[0, :4] == 0).all() and (got[0, 4:] != 0).any()
    got_s = port_attention(*t, causal=causal, scale=0.3).numpy()
    np.testing.assert_allclose(
        got_s, np.asarray(jax_attention(q, k, v, causal=causal, scale=0.3)),
        rtol=0, atol=ATT_TOL)
    # ring attention without a mesh, or on a one-device axis, is the same;
    # over two slots the ring gives it within the tolerance
    for mesh in (None, make_mesh(devices=["cpu"])):
        np.testing.assert_array_equal(port_ring(
            *t, mesh=mesh, causal=causal, k_mask=torch.from_numpy(k_mask)).numpy(), got)
    two = port_ring(*t, mesh=make_mesh(devices=["cpu"] * 2), causal=causal,
                    k_mask=torch.from_numpy(k_mask)).numpy()
    np.testing.assert_allclose(two, want, rtol=0, atol=ATT_TOL)
    assert (two[2] == 0).all()
    with pytest.raises(ValueError, match="no axis"):
        port_ring(*t, mesh=make_mesh(MeshConfig({"model": 1}), devices=["cpu"]))


@pytest.mark.parametrize("l2", [None, 1e-3])
@pytest.mark.parametrize("geom", [dict(), dict(num_heads=4, seq_len=20)])
def test_forward_loss_and_gradients_match(l2, geom):
    jp, pp = _params("jax", **geom), _params("port", **geom)
    params = jax_sr.init_params(N_ITEMS, jp)
    X, Y = jax_sr.make_training_batches(_sequences(), jp, 7)
    # train the JAX weights a few steps so the gradients are not the init's
    tx = jax_sr._make_tx()
    jparams = jax.tree.map(jnp.asarray, params)
    st = tx.init(jparams)
    grad = jax.jit(lambda prm, x, y: jax.grad(jax_sr._loss)(prm, x, y, jp))
    for b in range(3):
        g = grad(jparams, jnp.asarray(X[b]), jnp.asarray(Y[b]))
        u, st = tx.update(g, st, jparams)
        jparams = optax.apply_updates(jparams, u)
    net = _net(jax.tree.map(np.asarray, jparams), pp)
    x, y = jnp.asarray(X[3]), jnp.asarray(Y[3])
    xt, yt = torch.from_numpy(X[3]).long(), torch.from_numpy(Y[3]).long()
    np.testing.assert_allclose(net(xt).detach().numpy(),
                               np.asarray(jax.jit(lambda prm, x: jax_sr.forward(prm, x, jp))(jparams, x)),
                               rtol=0, atol=FWD_TOL)
    jl2 = None if l2 is None else jnp.float32(l2)
    jloss, jg = jax.jit(lambda prm, x, y: jax.value_and_grad(jax_sr._loss)(
        prm, x, y, jp, None, jl2))(jparams, x, y)
    loss = port_sr._loss(net, xt, yt, l2)
    assert abs(float(loss) - float(jloss)) <= FWD_TOL
    grads = torch.autograd.grad(loss, net.leaves())
    assert _rel(_leaves(jg), [t.numpy() for t in grads]) <= GRAD_TOL
    # PAD's row gets gradient through the tied softmax
    assert np.abs(grads[net.paths.index(("item_emb",))][0].numpy()).max() > 0


def _port_from_optax(params, st, p):
    """The port's net and Adam in optax's state ``st`` at ``params``."""
    net = _net(jax.tree.map(np.asarray, params), p)
    opt = port_sr.Adam(net.leaves(), float(st.hyperparams["learning_rate"]))
    inner = st.inner_state[0]
    opt.count = int(inner.count)
    with torch.no_grad():
        for t, m, v in zip(opt.mu, _leaves(inner.mu), _leaves(inner.nu)):
            t.copy_(torch.from_numpy(m))
        for t, v in zip(opt.nu, _leaves(inner.nu)):
            t.copy_(torch.from_numpy(v))
    return net, opt


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_three_adam_steps_from_optax_state_match(l2):
    jp, pp = _params("jax", l2=l2), _params("port", l2=l2)
    X, Y = jax_sr.make_training_batches(_sequences(), jp, 7)
    tx = jax_sr._make_tx()
    params = jax.tree.map(jnp.asarray, jax_sr.init_params(N_ITEMS, jp))
    st = tx.init(params)
    st.hyperparams["learning_rate"] = jnp.float32(3e-3)
    for b in range(3):
        net, opt = _port_from_optax(params, st, pp)
        assert opt.lr == float(np.float32(3e-3))
        g = jax.grad(jax_sr._loss)(params, jnp.asarray(X[b]), jnp.asarray(Y[b]), jp,
                                   None, jnp.float32(l2) if l2 else None)
        u, st = tx.update(g, st, params)
        params = optax.apply_updates(params, u)
        loss = port_sr._loss(net, torch.from_numpy(X[b]).long(),
                             torch.from_numpy(Y[b]).long(),
                             float(np.float32(l2)) if l2 else None)
        opt.step(list(torch.autograd.grad(loss, net.leaves())))
        assert opt.count == int(st.inner_state[0].count) == b + 1
        assert _rel(_leaves(params), [t.detach().numpy() for t in net.leaves()]) <= STEP_TOL
        assert _rel(_leaves(st.inner_state[0].mu), [t.numpy() for t in opt.mu]) <= GRAD_TOL


def _meshes(slots, axis="data"):
    return (make_mesh(MeshConfig({axis: slots}), devices=["cpu"] * slots),
            jax_make_mesh(JaxMeshConfig({axis: slots}), devices=jax.devices("cpu")[:slots]))


@pytest.mark.parametrize("slots", [2, 4])
def test_ring_forward_loss_gradients_and_steps_match_over_a_mesh(slots):
    """seq_len 12 over 2 and 4 slots; 70 sequences in batches of 16, so
    the last batch repeats rows (the loss masks them as one device does)."""
    jp, pp = _params("jax"), _params("port")
    mesh, jmesh = _meshes(slots)
    X, Y = jax_sr.make_training_batches(_sequences(), jp, 7)
    tx = jax_sr._make_tx()
    params = jax.tree.map(jnp.asarray, jax_sr.init_params(N_ITEMS, jp))
    st = tx.init(params)
    for b in range(3):
        net, opt = _port_from_optax(params, st, pp)
        x, y = jnp.asarray(X[b]), jnp.asarray(Y[b])
        xt, yt = torch.from_numpy(X[b]).long(), torch.from_numpy(Y[b]).long()
        np.testing.assert_allclose(
            net(xt, mesh).detach().numpy(),
            np.asarray(jax_sr.forward(params, x, jp, mesh=jmesh)), rtol=0, atol=FWD_TOL)
        jloss, g = jax.value_and_grad(jax_sr._loss)(params, x, y, jp, jmesh)
        loss = port_sr._loss(net, xt, yt, None, mesh)
        assert abs(float(loss) - float(jloss)) <= FWD_TOL
        grads = torch.autograd.grad(loss, net.leaves())
        assert _rel(_leaves(g), [t.numpy() for t in grads]) <= GRAD_TOL
        u, st = tx.update(g, st, params)
        params = optax.apply_updates(params, u)
        opt.step(list(grads))
        assert _rel(_leaves(params), [t.detach().numpy() for t in net.leaves()]) <= STEP_TOL


@pytest.mark.parametrize("how", ["ring", "indivisible", "no_axis"])
def test_training_over_a_mesh_runs_as_the_jax_packages(how):
    slots, axis = {"ring": (4, "data"), "indivisible": (8, "data"),
                   "no_axis": (2, "model")}[how]
    mesh, jmesh = _meshes(slots, axis)
    seqs = _sequences()
    jparams, jl = jax_sr.seq_rec_train(seqs, N_ITEMS, _params("jax", epochs=2), mesh=jmesh)
    pparams, pl = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=2), mesh=mesh,
                                        device="cpu")
    assert _rel(_leaves(jparams), _leaves(pparams)) <= 1e-4
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-5)
    if how != "ring":   # local attention: the one-device run, bit for bit
        local, _ = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=2),
                                         device="cpu")
        for a, b in zip(_leaves(local), _leaves(pparams)):
            np.testing.assert_array_equal(a, b)


def test_training_runs_as_the_jax_packages_and_needs_a_card(monkeypatch):
    seqs = _sequences()
    jparams, jl = jax_sr.seq_rec_train(seqs, N_ITEMS, _params("jax", epochs=3))
    pparams, pl = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=3),
                                        device="cpu")
    assert jax.tree.structure(pparams) == jax.tree.structure(jparams)
    assert _rel(_leaves(jparams), _leaves(pparams)) <= 1e-4
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-5)
    assert pl.dtype == np.float32 and pl.shape == (3,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sr.seq_rec_train(seqs, N_ITEMS, _params("port"))


def test_resume_is_bitwise_the_straight_run_and_this_runs_lr_wins(tmp_path):
    seqs = _sequences()
    straight, sl = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=3),
                                         device="cpu")
    ck = str(tmp_path / "ck")
    _, first = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=2, checkpoint_dir=ck),
                                     device="cpu")
    assert len(first) == 2
    resumed, rl = port_sr.seq_rec_train(
        seqs, N_ITEMS, _params("port", epochs=3, checkpoint_dir=ck), device="cpu")
    assert len(rl) == 1 and rl[0] == sl[2]     # one epoch ran
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        np.testing.assert_array_equal(a, b)
    # resumed at lr 0: this run's rate wins, nothing moves
    ck2 = str(tmp_path / "ck2")
    two, _ = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=2, checkpoint_dir=ck2),
                                   device="cpu")
    frozen, _ = port_sr.seq_rec_train(
        seqs, N_ITEMS, _params("port", epochs=3, lr=0.0, checkpoint_dir=ck2), device="cpu")
    for a, b in zip(_leaves(two), _leaves(frozen)):
        np.testing.assert_array_equal(a, b)
    # another geometry: the stale checkpoints are wiped, training starts over
    with pytest.warns(RuntimeWarning, match="stale"):
        wide, _ = port_sr.seq_rec_train(
            seqs, N_ITEMS, _params("port", epochs=1, hidden=8, checkpoint_dir=ck2),
            device="cpu")
    fresh, _ = port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=1, hidden=8),
                                     device="cpu")
    for a, b in zip(_leaves(wide), _leaves(fresh)):
        np.testing.assert_array_equal(a, b)
    # checkpoints every 2 epochs of 5: saved at 2, 4 and the end
    ck3 = str(tmp_path / "ck3")
    port_sr.seq_rec_train(seqs, N_ITEMS, _params("port", epochs=5, checkpoint_dir=ck3,
                                                 checkpoint_every=2), device="cpu")
    import os
    assert sorted(os.listdir(ck3), key=int) == ["2", "4", "5"][-3:]


@pytest.mark.parametrize("history", [[3, 9, 4, 1], [], list(range(1, 40)), [0, 0, 7]])
def test_scores_match(history):
    jp, pp = _params("jax"), _params("port")
    params, _ = jax_sr.seq_rec_train(_sequences(), N_ITEMS, _params("jax", epochs=1))
    want = jax_sr.seq_rec_scores(params, history, jp)
    params = jax.tree.map(np.asarray, params)
    for arg in (params, _net(params, pp)):
        got = port_sr.seq_rec_scores(arg, history, pp, device="cpu")
        assert got.shape == want.shape and got[0] == -np.inf
        np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=SCORE_TOL)


# -- the template on one home --------------------------------------------------


def _seed_seq(storage, app_name="SeqApp"):
    """60 users walking a ring of 30 items in order (with noise), events
    one second apart."""
    import datetime as dt

    app = storage.meta.create_app(app_name)
    storage.events.init_channel(app.id)
    rng = np.random.default_rng(5)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    evs = []
    for u in range(60):
        start, n = int(rng.integers(0, 30)), int(rng.integers(4, 16))
        for j in range(n):
            item = (start + j) % 30 if rng.random() < 0.85 else int(rng.integers(0, 30))
            evs.append(JaxEvent(event=("view", "buy")[j % 2], entity_type="user",
                                entity_id=f"u{u}", target_entity_type="item",
                                target_entity_id=f"i{item}",
                                event_time=t0 + dt.timedelta(seconds=60 * u + j)))
    storage.events.insert_batch(evs, app.id)


def _variant(factory):
    return {"engineFactory": factory,
            "datasource": {"params": {"appName": "SeqApp"}},
            "algorithms": [{"name": "seqrec", "params": {
                "hidden": 16, "numBlocks": 1, "numHeads": 2, "seqLen": 16,
                "epochs": 4, "batchSize": 32}}]}


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    home = str(tmp_path_factory.mktemp("pio_seqrec"))
    js = JaxStorage(JaxStorageConfig(home=home))
    _seed_seq(js)
    ids = {"jax": jax_run_train(JAX_SEQUENTIALREC_FACTORY,
                                variant=_variant(JAX_SEQUENTIALREC_FACTORY),
                                storage=js, use_mesh=False),
           "port": run_train(SEQUENTIALREC_FACTORY, variant=_variant(SEQUENTIALREC_FACTORY),
                             storage=Storage(StorageConfig(home=home)), device="cpu")}
    return home, ids


def _agree(a, b):
    """Equal up to near-ties: the same length, scores within SCORE_TOL
    position by position, and where the items differ, the other's item is
    near-tied with this position's score in ``a`` (a swap) or, absent
    from ``a``, with ``a``'s last (a cut)."""
    sa, sb = a["itemScores"], b["itemScores"]
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert abs(x["score"] - y["score"]) <= SCORE_TOL
    where = {x["item"]: j for j, x in enumerate(sa)}
    for x, y in zip(sa, sb):
        if x["item"] != y["item"]:
            ref = sa[where[y["item"]]]["score"] if y["item"] in where else sa[-1]["score"]
            assert abs(ref - x["score"]) <= 2 * SCORE_TOL, (x, y)


SEQ_QUERIES = [{"history": ["i1", "i2", "i3"], "num": 5},
               {"history": ["i28", "i29", "i0", "unknown"], "num": 8},
               {"history": [], "num": 4},
               {"history": ["i5", "i6"], "num": 6, "blackList": ["i7", "i8"]},
               {"user": "u3", "num": 5}, {"user": "u40", "num": 10},
               {"user": "nobody", "num": 3}, {"history": ["i10"], "num": 100}]


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_each_package_serves_each_instance_alike(home, trained_by):
    home, ids = home
    jd = jax_prepare_deploy(instance_id=ids[trained_by],
                            storage=JaxStorage(JaxStorageConfig(home=home)))
    pd = prepare_deploy(instance_id=ids[trained_by], storage=Storage(StorageConfig(home=home)),
                        device="cpu")
    model = pd.models[0]
    assert isinstance(model, port_engine.SeqRecModel)
    for q in SEQ_QUERIES:
        _agree(pd.query(q), jd.query(q))
    assert isinstance(model._net, port_sr.SeqRecNet)       # resident after a query
    assert pickle.loads(pickle.dumps(model))._net is None  # and not pickled
    assert len(pd.query({"history": ["i10"], "num": 100})["itemScores"]) == 30


def test_both_packages_train_the_same_model(home):
    home, ids = home
    jblob = pickle.loads(JaxStorage(JaxStorageConfig(home=home)).models.get(ids["jax"]))[0]
    pblob = pickle.loads(Storage(StorageConfig(home=home)).models.get(ids["port"]))[0]
    j, p = pickle.loads(jblob), pickle.loads(pblob)     # the JAX package's unpickler
    assert p["item_ids"] == j["item_ids"] and p["app_name"] == j["app_name"]
    assert _rel(_leaves(j["params"]), _leaves(p["params"])) <= 1e-4
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5)


def test_blob_crosses_both_ways(home):
    home, ids = home
    pblob = pickle.loads(Storage(StorageConfig(home=home)).models.get(ids["port"]))[0]
    d = pickle.loads(pblob)
    assert type(d["hp"]) is jax_sr.SeqRecParams and d["hp"].seq_len == 16
    assert type(d["algo_params"]) is jax_engine.SeqRecAlgorithmParams
    assert jax.tree.structure(d["params"]) == jax.tree.structure(
        jax_sr.init_params(30, d["hp"]))
    jblob = pickle.loads(JaxStorage(JaxStorageConfig(home=home)).models.get(ids["jax"]))[0]
    algo = port_engine.SeqRecAlgorithm(port_engine.SeqRecAlgorithmParams())
    algo.device = torch.device("cpu")
    m = algo.load_model(jblob, None)
    assert type(m.hp) is port_sr.SeqRecParams
    assert type(m.algo_params) is port_engine.SeqRecAlgorithmParams
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        algo.load_model(pickle.dumps(jax_engine.DataSourceParams()), None)


def test_hit_rate_equals_the_jax_packages(home, monkeypatch):
    home, _ = home
    monkeypatch.setenv("PIO_EVAL_APP_NAME", "SeqApp")
    js, ps = JaxStorage(JaxStorageConfig(home=home)), Storage(StorageConfig(home=home))
    grid = [(g, dict(epochs=6)) for g in (8, 16)]
    jgrid = [jax_engine.EngineParams(
        data_source_params=jax_engine.DataSourceParams(app_name="SeqApp"),
        algorithms_params=[("seqrec", jax_engine.SeqRecAlgorithmParams(
            hidden=h, num_blocks=1, seq_len=16, **kw))]) for h, kw in grid]
    pgrid = [port_engine.EngineParams(
        data_source_params=port_engine.DataSourceParams(app_name="SeqApp"),
        algorithms_params=[("seqrec", port_engine.SeqRecAlgorithmParams(
            hidden=h, num_blocks=1, seq_len=16, **kw))]) for h, kw in grid]
    jax_registry.set_storage(js)
    port_registry.set_storage(ps)
    try:
        _, jres = jax_run_evaluation(jax_engine.SeqRecEvaluation(), jgrid, storage=js,
                                     use_mesh=False)
        _, pres = run_evaluation(port_engine.SeqRecEvaluation(), pgrid, storage=ps,
                                 device="cpu")
    finally:
        jax_registry.set_storage(None)
        port_registry.set_storage(None)
    assert port_engine.SeqRecEvaluation.metric.header == "HitRate@10"
    assert [s for _, s, _ in pres.candidates] == [s for _, s, _ in jres.candidates]
    assert [o for _, _, o in pres.candidates] == [o for _, _, o in jres.candidates]
    assert pres.best_index == jres.best_index
    assert [c.algorithms_params[0][1].hidden for c in
            (e for e, _, _ in pres.candidates)] == [8, 16]
    assert len(port_engine.DefaultGrid().engine_params_list) == 2
