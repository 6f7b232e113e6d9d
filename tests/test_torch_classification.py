"""The port's classification slice held against the JAX package, on the CPU.

Both packages run in one process on the same numpy-seeded inputs:

- ``ops/segment``: sums, counts and means equal to the JAX package's on
  sorted, unsorted, negative (wrapping) and out-of-range (dropped) ids
  and with an empty segment;
- naive Bayes (multinomial and bernoulli) within 1e-6;
- logistic regression through the port's copy of ``optax.lbfgs()``:
  W and b within 1e-5 (of max |W|) after 1 and 5 iterations, within 1e-4
  after 100 with reg > 0 and the float64 loss within 1e-6 relative; on
  separable data with reg 0 (|W| in the hundreds) equal labels on
  training and held-out rows up to near-ties within 1e-3 relative; one
  class only; Adam; ``logreg_train_many`` and the sweep's ``one`` per
  candidate against the JAX package's vmapped programs;
- the forest from ``jax.random``'s draws (split as ``_train_compiled``
  splits them) through ``forest_train_drawn``: equal ``feats``/``thrs``,
  ``leaf_probs`` within 1e-6; duplicate columns split on the first;
  ``forest_predict_proba`` equal;
- ``hash_features`` bit-equal;
- the classification and text templates trained, deployed and queried
  through both packages with equal answers, blobs loaded both ways, a
  mesh of more than one device refused, no card and no CPU request
  refused; serial and distributed ``run_evaluation`` with equal scores
  and leaderboard digests (the port's forest given the JAX draws);
- the CLI: twin homes, ``train`` and ``deploy`` of each package, equal
  answers over HTTP.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.models import forest as jax_forest
from predictionio_tpu.models import linear as jax_linear
from predictionio_tpu.models import naive_bayes as jax_nb
from predictionio_tpu.ops import segment as jax_segment
from predictionio_tpu.storage import leaderboard as jax_lb
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.classification import engine as jax_cls
from predictionio_tpu.templates.textclassification import engine as jax_text
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.core.workflow import (
    CLASSIFICATION_FACTORY,
    JAX_CLASSIFICATION_FACTORY,
    JAX_TEXTCLASSIFICATION_FACTORY,
    TEXTCLASSIFICATION_FACTORY,
    prepare_deploy,
    run_evaluation,
    run_train,
)
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.models import forest as port_forest
from predictionio_tpu_torch.models import linear as port_linear
from predictionio_tpu_torch.models import naive_bayes as port_nb
from predictionio_tpu_torch.ops import segment as port_segment
from predictionio_tpu_torch.storage import leaderboard as lb
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.classification import engine as port_cls
from predictionio_tpu_torch.templates.textclassification import engine as port_text
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.utils.device import check_mesh
from tests.test_torch_cli import _run
from tests.test_torch_event_server import ServerThread, request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_TOL = 1e-6
W_TOL = 1e-5       # 1 and 5 L-BFGS iterations, of max |W|
W100_TOL = 1e-4    # 100 iterations with reg > 0, of max |W|
LOSS_RTOL = 1e-6   # float64 loss at the final weights, relative
TIE_RTOL = 1e-3    # separable data: the width of a near-tie of logits
FOREST_TOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- segment ops -----------------------------------------------------------------

SEGMENT_CASES = {
    "sorted": ([0, 0, 1, 2, 2, 2], 4),
    "unsorted": ([2, 0, 3, 0, 1, 3], 4),
    "negative": ([-1, 0, -4, 2, -2, 1], 4),
    "out_of_range": ([0, 5, 1, -7, 4, 2], 4),
    "empty_segment": ([0, 0, 3, 3, 3, 0], 5),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_ops_equal_the_jax_packages(case):
    ids, num = SEGMENT_CASES[case]
    rng = np.random.default_rng(len(case))
    for data in (rng.normal(size=6).astype(np.float32),
                 rng.normal(size=(6, 3)).astype(np.float32),
                 rng.integers(-5, 5, size=6).astype(np.int32)):
        got = port_segment.segment_sum(_t(data), _t(ids), num)
        want = np.asarray(jax_segment.segment_sum(jnp.asarray(data), jnp.asarray(ids), num))
        assert got.dtype == torch.as_tensor(data).dtype
        np.testing.assert_array_equal(got.numpy(), want)
        if data.dtype == np.float32:
            np.testing.assert_allclose(
                port_segment.segment_mean(_t(data), _t(ids), num).numpy(),
                np.asarray(jax_segment.segment_mean(jnp.asarray(data), jnp.asarray(ids), num)),
                rtol=1e-6)
    count = port_segment.segment_count(_t(ids), num, sorted_ids=True)
    assert count.dtype == torch.int32
    np.testing.assert_array_equal(
        count.numpy(), np.asarray(jax_segment.segment_count(jnp.asarray(ids), num)))


def test_segment_sum_wraps_negatives_and_drops_the_rest():
    out = port_segment.segment_sum(torch.ones(4), torch.tensor([0, -1, 5, 1]), 3)
    assert out.tolist() == [1.0, 1.0, 1.0]


# -- naive Bayes -----------------------------------------------------------------


def _counts(seed=0, n=300, d=12, C=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n).astype(np.int32)
    rates = rng.gamma(2.0, 1.0, size=(C, d))
    X = rng.poisson(rates[y]).astype(np.float32)
    return X, y


@pytest.mark.parametrize("model_type", ["multinomial", "bernoulli"])
@pytest.mark.parametrize("lam", [1.0, 0.3])
def test_naive_bayes_matches_the_jax_package(model_type, lam):
    X, y = _counts()
    lp, lt = jax_nb.nb_train(X, y, jax_nb.NaiveBayesParams(lambda_=lam, model_type=model_type))
    plp, plt = port_nb.nb_train(X, y, port_nb.NaiveBayesParams(lambda_=lam, model_type=model_type),
                                device="cpu")
    np.testing.assert_allclose(plp, lp, atol=NB_TOL, rtol=NB_TOL)
    np.testing.assert_allclose(plt, lt, atol=NB_TOL, rtol=NB_TOL)
    Xq, _ = _counts(seed=1, n=50)
    np.testing.assert_array_equal(port_nb.nb_predict(plp, plt, Xq, model_type),
                                  jax_nb.nb_predict(lp, lt, Xq, model_type))


# -- logistic regression ------------------------------------------------------------


def _blobs(seed=0, n=240, d=6, C=3, noise=1.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(d, C)) + noise * rng.normal(size=(n, C)),
                  1).astype(np.int32)
    return X, y


def _lr(pkg, X, y, **kw):
    mod = jax_linear if pkg == "jax" else port_linear
    p = mod.LogisticRegressionParams(**kw)
    if pkg == "jax":
        return mod.logreg_train(X, y, p)
    return mod.logreg_train(X, y, p, device="cpu")


def _loss64(W, b, X, y, reg):
    z = X.astype(np.float64) @ W.astype(np.float64) + b.astype(np.float64)
    zmax = z.max(1, keepdims=True)
    lse = np.log(np.exp(z - zmax).sum(1)) + zmax[:, 0]
    return float((lse - z[np.arange(len(y)), y]).mean()
                 + 0.5 * reg * (W.astype(np.float64) ** 2).sum())


@pytest.mark.parametrize("iterations", [1, 5])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_lbfgs_first_steps_match_optax(iterations, reg):
    X, y = _blobs()
    W, b = _lr("jax", X, y, num_classes=3, iterations=iterations, reg=reg)
    pW, pb = _lr("port", X, y, num_classes=3, iterations=iterations, reg=reg)
    scale = np.abs(W).max()
    assert np.abs(pW - W).max() <= W_TOL * scale
    assert np.abs(pb - b).max() <= W_TOL * scale


@pytest.mark.parametrize("reg", [1e-3, 0.1])
def test_lbfgs_100_iterations_with_reg_match_optax(reg):
    X, y = _blobs(seed=2)
    W, b = _lr("jax", X, y, num_classes=3, iterations=100, reg=reg)
    pW, pb = _lr("port", X, y, num_classes=3, iterations=100, reg=reg)
    scale = np.abs(W).max()
    assert np.abs(pW - W).max() <= W100_TOL * scale
    assert np.abs(pb - b).max() <= W100_TOL * scale
    ref = _loss64(W, b, X, y, reg)
    assert abs(_loss64(pW, pb, X, y, reg) - ref) <= LOSS_RTOL * abs(ref)


def _labels_agree(Wa, ba, Wb, bb, X):
    """Equal argmax labels, except rows whose top two logits (of the first
    model) lie within TIE_RTOL relative."""
    za, zb = X @ Wa + ba, X @ Wb + bb
    top2 = np.sort(za, 1)[:, -2:]
    tie = np.abs(top2[:, 1] - top2[:, 0]) <= TIE_RTOL * np.abs(top2).max(1)
    agree = np.argmax(za, 1) == np.argmax(zb, 1)
    return bool(np.all(agree | tie)), int(tie.sum())


def test_lbfgs_on_separable_data_gives_the_jax_labels():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(260, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 3] > 0).astype(np.int32)
    tr, te = slice(0, 200), slice(200, None)
    W, b = _lr("jax", X[tr], y[tr], num_classes=2, iterations=100)
    pW, pb = _lr("port", X[tr], y[tr], num_classes=2, iterations=100)
    assert np.abs(W).max() > 50 and np.abs(pW).max() > 50  # far from zero
    assert np.all(np.isfinite(pW)) and np.all(np.isfinite(pb))
    for rows in (tr, te):
        ok, _ = _labels_agree(W, b, pW, pb, X[rows])
        assert ok


def test_lbfgs_on_one_class_matches_optax():
    """One class: the loss falls to f32's floor, and from there both runs
    move by rounding alone; the first steps agree, every step is finite
    and every label is the class."""
    X, _ = _blobs(seed=4, n=80)
    y = np.zeros(80, np.int32)
    W, b = _lr("jax", X, y, num_classes=2, iterations=5)
    pW, pb = _lr("port", X, y, num_classes=2, iterations=5)
    scale = max(np.abs(W).max(), np.abs(b).max())
    assert np.abs(pW - W).max() <= W_TOL * scale
    assert np.abs(pb - b).max() <= W_TOL * scale
    for reg in (0.0, 1e-3):
        pW, pb = _lr("port", X, y, num_classes=2, iterations=100, reg=reg)
        assert np.all(np.isfinite(pW)) and np.all(np.isfinite(pb))
        assert (port_linear.logreg_predict(pW, pb, X) == 0).all()


@pytest.mark.parametrize("iterations", [30, 200])
def test_adam_matches_optax(iterations):
    # no class holds exactly 1/C of the rows here: where one does (80 of
    # 240 at seed 5), that class's bias gradient is 0 up to rounding, and
    # Adam's first step divides it by its own magnitude, moving the bias
    # by ±lr on the sign of f32 noise in either package
    X, y = _blobs(seed=0)
    assert all(3 * c != len(y) for c in np.bincount(y))
    kw = dict(num_classes=3, iterations=iterations, optimizer="adam",
              learning_rate=0.3, reg=1e-3)
    W, b = _lr("jax", X, y, **kw)
    pW, pb = _lr("port", X, y, **kw)
    scale = np.abs(W).max()
    assert np.abs(pW - W).max() <= W100_TOL * scale
    assert np.abs(pb - b).max() <= W100_TOL * scale


GRID_REGS = (1e-3, 1e-2, 0.1)


def test_train_many_equals_the_jax_vmapped_grid():
    X, y = _blobs(seed=6)
    cands = [dict(num_classes=3, iterations=40, reg=r) for r in GRID_REGS] + [
        dict(num_classes=4, iterations=40, reg=0.05),
        dict(num_classes=3, iterations=40, reg=0.01, optimizer="adam")]
    theirs = jax_linear.logreg_train_many(
        X, y, [jax_linear.LogisticRegressionParams(**c) for c in cands])
    mine = port_linear.logreg_train_many(
        X, y, [port_linear.LogisticRegressionParams(**c) for c in cands], device="cpu")
    assert len(mine) == len(cands)
    for (W, b), (pW, pb) in zip(theirs, mine):
        assert pW.shape == W.shape
        scale = np.abs(W).max()
        assert np.abs(pW - W).max() <= W100_TOL * scale
        # the 4-class candidate's class 3 has no rows: its bias runs off
        # to -inf against the others (a flat direction rounding steers),
        # so the biases are held on the data's classes, up to their shift
        bc, pbc = b[:3] - b[:3].mean(), pb[:3] - pb[:3].mean()
        assert np.abs(pbc - bc).max() <= W100_TOL * scale
        np.testing.assert_array_equal(port_linear.logreg_predict(pW, pb, X),
                                      jax_linear.logreg_predict(W, b, X))


def test_sweep_programs_score_as_the_jax_packages():
    X, y = _blobs(seed=7)
    Xe, ye = _blobs(seed=8, n=90)
    hyper = np.asarray([[r, 0.1] for r in GRID_REGS], np.float32)
    _, jbuild, jdata = jax_linear.logreg_sweep_program(X, y, Xe, ye, 3, 40)
    _, pbuild, pdata = port_linear.logreg_sweep_program(X, y, Xe, ye, 3, 40, device="cpu")
    jone, pone = jbuild(), pbuild()
    jargs = [jnp.asarray(a) for a in jdata]
    for row in hyper:
        jc, jn = jone(jnp.asarray(row), *jargs)
        pc, pn = pone(row, *pdata)
        assert float(pn) == float(jn) == 90.0
        assert abs(float(pc) - float(jc)) <= 1.0  # a near-tie row at most
    Xc, yc = _counts()
    Xq, yq = _counts(seed=3, n=70)
    for bern in (False, True):
        _, jbuild, jdata = jax_nb.nb_sweep_program(Xc, yc, Xq, yq, 4, bern)
        _, pbuild, pdata = port_nb.nb_sweep_program(Xc, yc, Xq, yq, 4, bern, device="cpu")
        for lam in (0.5, 1.0):
            jc, _ = jbuild()(jnp.asarray([lam], jnp.float32), *[jnp.asarray(a) for a in jdata])
            pc, _ = pbuild()(np.asarray([lam], np.float32), *pdata)
            assert float(pc) == float(jc)


# -- the forest ------------------------------------------------------------------


def jax_draws(n, d, p):
    """``jax.random``'s bootstrap counts (T, n) and level masks (T, D, d),
    with the keys split as the JAX package's ``_train_compiled`` splits them."""
    keys = jax.random.split(jax.random.PRNGKey(p.seed), p.n_trees)
    boots, keeps = [], []
    for key in keys:
        kb, kf = jax.random.split(key)
        boots.append(np.asarray(jax.random.multinomial(kb, n, jnp.full((n,), 1.0 / n))))
        keeps.append([np.asarray(jax.random.uniform(k, (d,)) < p.feature_frac)
                      for k in jax.random.split(kf, p.max_depth)])
    return np.asarray(boots, np.float32), np.asarray(keeps)


def carry_jax_draws(monkeypatch):
    """Make the port's forest draw what the JAX package draws."""
    monkeypatch.setattr(port_forest, "forest_draws", jax_draws)


def _forest_pair(X, y, **kw):
    jp = jax_forest.ForestParams(**kw)
    jm = jax_forest.forest_train(X, y, jp)
    boot, keep = jax_draws(X.shape[0], X.shape[1], jp)
    pm = port_forest.forest_train_drawn(X, y, port_forest.ForestParams(**kw), boot, keep,
                                        device="cpu")
    return jm, pm


@pytest.mark.parametrize("seed,shape,kw", [
    (1, (400, 6), dict(n_trees=6, max_depth=4, n_thresholds=8, seed=3)),
    (2, (300, 9), dict(n_trees=4, max_depth=5, n_thresholds=16, seed=0, feature_frac=0.5)),
])
def test_forest_from_jax_draws_grows_the_jax_trees(seed, shape, kw):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=shape).astype(np.float32)
    y = (((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.int32) + (X[:, 2] > 1)).astype(np.int32)
    jm, pm = _forest_pair(X, y, **kw)
    np.testing.assert_array_equal(pm.feats, jm.feats)
    np.testing.assert_array_equal(pm.thrs, jm.thrs)
    np.testing.assert_allclose(pm.leaf_probs, jm.leaf_probs, atol=FOREST_TOL)
    assert pm.n_classes == jm.n_classes
    Xq = rng.normal(size=(50, shape[1])).astype(np.float32)
    np.testing.assert_array_equal(port_forest.forest_predict_proba(jm, Xq),
                                  jax_forest.forest_predict_proba(jm, Xq))


def test_forest_splits_duplicate_columns_on_the_first():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(200, 2)).astype(np.float32)
    X = np.concatenate([base[:, :1], base[:, :1], base[:, 1:]], 1)  # cols 0, 1 equal
    y = (base[:, 0] > 0.1).astype(np.int32)
    kw = dict(n_trees=3, max_depth=2, n_thresholds=8, seed=5, feature_frac=1.0)
    jm, pm = _forest_pair(X, y, **kw)
    np.testing.assert_array_equal(pm.feats, jm.feats)
    assert pm.feats[:, 0].tolist() == [0, 0, 0]


def test_forest_seeded_draws_are_the_ports_own_and_repeat():
    X, y = _blobs(seed=9, n=120)
    p = port_forest.ForestParams(n_trees=3, max_depth=3, seed=4)
    a = port_forest.forest_train(X, y, p, device="cpu")
    b = port_forest.forest_train(X, y, p, device="cpu")
    np.testing.assert_array_equal(a.feats, b.feats)
    np.testing.assert_array_equal(a.leaf_probs, b.leaf_probs)
    boot, keep = port_forest.forest_draws(120, X.shape[1], p)
    assert boot.shape == (3, 120) and boot.sum().item() == 3 * 120
    assert keep.shape == (3, 3, X.shape[1]) and keep.dtype == torch.bool


# -- the hashing featurizer -----------------------------------------------------------


def _docs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    words = ["alpha", "Beta", "gamma's", "δelta", "x1", "2024", "the", "a", "b-c", "QUICK!"]
    return [" ".join(rng.choice(words, size=rng.integers(0, 30))) for _ in range(n)]


@pytest.mark.parametrize("bits,ngrams", [(12, 2), (6, 3), (10, 1)])
def test_hash_features_are_bit_equal(bits, ngrams):
    texts = _docs() + ["", "   ", "Hello, World! hello world"]
    got = port_text.hash_features(texts, port_text.HashingConfig(bits, ngrams))
    want = jax_text.hash_features(texts, jax_text.HashingConfig(bits, ngrams))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# -- the templates ---------------------------------------------------------------

CLS_APP, TEXT_APP = "ClsApp", "TextApp"


def _cls_events(event_cls, n=150, seed=5):
    rng = np.random.default_rng(seed)
    centers = np.asarray([[0.5, 0.5, 3.0], [4.0, 4.0, 0.5], [0.5, 4.0, 4.0]])
    out = []
    for i in range(n):
        label = int(rng.integers(0, 3))
        f = np.abs(rng.normal(centers[label], 1.2))
        out.append(event_cls(event="$set", entity_type="user", entity_id=f"u{i}",
                             properties={"attr0": float(f[0]), "attr1": float(f[1]),
                                         "attr2": float(f[2]), "label": label}))
    return out


TOPICS = [["ball", "goal", "team", "match"], ["vote", "law", "party", "senate"],
          ["cpu", "code", "linux", "kernel"]]


def _text_events(event_cls, n=90, seed=6):
    rng = np.random.default_rng(seed)
    common = ["the", "a", "of", "and", "to"]
    out = []
    for i in range(n):
        label = i % 3
        words = list(rng.choice(TOPICS[label], size=6)) + list(rng.choice(common, size=6))
        rng.shuffle(words)
        out.append(event_cls(event="$set", entity_type="doc", entity_id=f"d{i}",
                             properties={"text": " ".join(words), "label": label}))
    return out


def _seed(storage, event_cls):
    for app, events in ((CLS_APP, _cls_events(event_cls)),
                        (TEXT_APP, _text_events(event_cls))):
        a = storage.meta.create_app(app)
        storage.events.init_channel(a.id)
        storage.events.insert_batch(events, a.id)


def _jax_storage(home):
    return JaxStorage(JaxStorageConfig(home=home))


def _port_storage(home):
    return Storage(StorageConfig(home=home))


ALGOS = {
    "nb": ("cls", "naive", {"lambda": 1.0}),
    "nb_bernoulli": ("cls", "naive", {"lambda": 0.5, "modelType": "bernoulli"}),
    "lr": ("cls", "lr", {"iterations": 40, "reg": 0.01}),
    "forest": ("cls", "forest", {"numTrees": 4, "maxDepth": 3, "nThresholds": 8}),
    "text_nb": ("text", "naive", {"lambda": 1.0}),
    "text_lr": ("text", "lr", {"iterations": 30, "reg": 0.01}),
}
FACTORIES = {"cls": (JAX_CLASSIFICATION_FACTORY, CLASSIFICATION_FACTORY),
             "text": (JAX_TEXTCLASSIFICATION_FACTORY, TEXTCLASSIFICATION_FACTORY)}


def _variant(kind, factory):
    tmpl, name, params = ALGOS[kind]
    ds = ({"appName": CLS_APP} if tmpl == "cls"
          else {"appName": TEXT_APP, "hashBits": 8})
    return {"id": kind, "engineFactory": factory, "datasource": {"params": ds},
            "algorithms": [{"name": name, "params": params}], "meshConf": {}}


def _queries(tmpl, seed=7):
    rng = np.random.default_rng(seed)
    if tmpl == "cls":
        return [{"attr0": float(a), "attr1": float(b), "attr2": float(c)}
                for a, b, c in np.abs(rng.normal(2.0, 2.0, size=(25, 3)))] + [{}]
    return [{"text": " ".join(rng.choice(sum(TOPICS, []) + ["the"], size=5))}
            for _ in range(25)] + [{"text": ""}]


@pytest.fixture(scope="module")
def home(tmp_path_factory, monkeypatch_module):
    """Both apps on one home; each package's instance of each algorithm
    (the port's forest from the JAX draws)."""
    carry_jax_draws(monkeypatch_module)
    home = str(tmp_path_factory.mktemp("pio_classification"))
    _seed(_jax_storage(home), JaxEvent)
    ids = {}
    for kind, (tmpl, _, _) in ALGOS.items():
        jf, pf = FACTORIES[tmpl]
        ids[kind, "jax"] = jax_run_train(jf, variant=_variant(kind, jf),
                                         storage=_jax_storage(home), use_mesh=False)
        ids[kind, "port"] = run_train(pf, variant=_variant(kind, pf),
                                      storage=_port_storage(home), device="cpu")
    return home, ids


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _deployed(home, instance_id, package):
    if package == "jax":
        return jax_prepare_deploy(instance_id=instance_id, storage=_jax_storage(home))
    return prepare_deploy(instance_id=instance_id, storage=_port_storage(home),
                          device="cpu")


@pytest.mark.parametrize("kind", sorted(ALGOS))
def test_template_answers_equal_across_packages(home, kind):
    """Each package's instance served by each package: one set of answers
    (logistic regression's two trainings: weights within 1e-4)."""
    home, ids = home
    qs = _queries(ALGOS[kind][0])
    answers = {(trained, served): [_deployed(home, ids[kind, trained], served).query(q)
                                   for q in qs]
               for trained in ("jax", "port") for served in ("jax", "port")}
    for trained in ("jax", "port"):
        assert answers[trained, "port"] == answers[trained, "jax"], trained
    if kind.endswith("lr"):
        ja = _deployed(home, ids[kind, "jax"], "port").models[0].arrays
        pa = _deployed(home, ids[kind, "port"], "port").models[0].arrays
        assert np.abs(pa["W"] - ja["W"]).max() <= W100_TOL * np.abs(ja["W"]).max()
    else:
        assert answers["port", "port"] == answers["jax", "jax"]


@pytest.mark.parametrize("kind", ["nb", "forest", "text_nb"])
def test_blobs_load_in_both_packages(home, kind):
    home, ids = home
    js, ps = _jax_storage(home), _port_storage(home)
    for iid in (ids[kind, "jax"], ids[kind, "port"]):
        blob = pickle.loads(ps.models.get(iid))[0]
        theirs = pickle.loads(blob)          # the JAX package's own unpickler
        mine = _deployed(home, iid, "port").models[0]
        assert type(theirs).__module__.startswith("predictionio_tpu.templates.")
        assert type(mine).__module__.startswith("predictionio_tpu_torch.templates.")
        assert type(mine).__name__ == type(theirs).__name__
        assert mine.arrays.keys() == theirs.arrays.keys()
        for k in mine.arrays:
            np.testing.assert_array_equal(mine.arrays[k], theirs.arrays[k])
        if kind == "text_nb":
            assert (mine.cfg.hash_bits, mine.cfg.ngrams) == (theirs.cfg.hash_bits,
                                                             theirs.cfg.ngrams)
    assert js.models.get(ids[kind, "port"]) is not None


def test_the_port_loads_a_jax_blob_without_the_jax_package(home, tmp_path):
    home, ids = home
    blobs = {k: pickle.loads(_port_storage(home).models.get(ids[k, "jax"]))[0]
             for k in ("nb", "text_lr")}
    path = tmp_path / "blobs.pkl"
    path.write_bytes(pickle.dumps(blobs))
    code = (
        "import pickle, sys\n"
        "from predictionio_tpu_torch.templates.classification import engine as c\n"
        "from predictionio_tpu_torch.templates.textclassification import engine as t\n"
        f"b = pickle.load(open({str(path)!r}, 'rb'))\n"
        "m = c.NaiveBayesAlgorithm().load_model(b['nb'], None)\n"
        "tm = t.TextLogisticRegressionAlgorithm().load_model(b['text_lr'], None)\n"
        "assert type(m) is c.ClassificationModel and type(tm.cfg) is t.HashingConfig\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'predictionio_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_instances_record_the_jax_factory(home):
    home, ids = home
    ps = _port_storage(home)
    for kind, (tmpl, _, _) in ALGOS.items():
        assert ps.meta.get_engine_instance(ids[kind, "port"]).engine_factory == \
            FACTORIES[tmpl][0]


def test_a_mesh_of_more_than_one_device_is_refused(home):
    home, _ = home
    v = _variant("nb", CLASSIFICATION_FACTORY)
    v["meshConf"] = {"mesh": {"data": 8}}
    ps = _port_storage(home)
    before = len(ps.meta.list_engine_instances())
    with pytest.raises(ValueError, match="queue 1, item 8"):
        run_train(CLASSIFICATION_FACTORY, variant=v, storage=ps, device="cpu")
    assert len(ps.meta.list_engine_instances()) == before
    for mesh_conf in ({"mesh": {"data": 2}}, {"mesh": {"data": 2, "model": 1}}):
        with pytest.raises(ValueError, match="queue 1, item 8"):
            check_mesh(mesh_conf)
    for mesh_conf in (None, {}, {"mesh": {}}, {"mesh": {"data": 1, "model": 1}}):
        check_mesh(mesh_conf)
    v["meshConf"] = {"mesh": {"data": 1}}
    iid = run_train(CLASSIFICATION_FACTORY, variant=v, storage=ps, device="cpu")
    assert ps.meta.get_engine_instance(iid).status == "COMPLETED"


def test_training_needs_a_card_or_a_cpu_request(home, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    home, _ = home
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(CLASSIFICATION_FACTORY, variant=_variant("nb", CLASSIFICATION_FACTORY),
                  storage=_port_storage(home))
    X, y = _counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_nb.nb_train(X, y, port_nb.NaiveBayesParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_forest.forest_train(X, y, port_forest.ForestParams(n_trees=1))


# -- pio eval --------------------------------------------------------------------


def _cls_grid(mod, engine_params):
    """DefaultGrid's shape: NB λ 0.5 and 1.0, LR, RF; evalK 2."""
    ds = mod.DataSourceParams(app_name=CLS_APP, eval_k=2)
    return [engine_params(data_source_params=ds,
                          algorithms_params=[("naive", mod.NBAlgoParams(lambda_=lam))])
            for lam in (0.5, 1.0)] + [
        engine_params(data_source_params=ds,
                      algorithms_params=[("lr", mod.LRAlgoParams(iterations=30,
                                                                 reg=0.01))]),
        engine_params(data_source_params=ds,
                      algorithms_params=[("lr", mod.LRAlgoParams(iterations=30,
                                                                 reg=0.1))]),
        engine_params(data_source_params=ds,
                      algorithms_params=[("forest", mod.RFAlgoParams(
                          num_trees=4, max_depth=3, n_thresholds=8))])]


def _text_grid(mod, engine_params):
    ds = mod.TextDataSourceParams(app_name=TEXT_APP, eval_k=2, hash_bits=8)
    return [engine_params(data_source_params=ds,
                          algorithms_params=[("naive", mod.TextNBParams(lambda_=lam))])
            for lam in (0.25, 1.0)] + [
        engine_params(data_source_params=ds,
                      algorithms_params=[("lr", mod.TextLRParams(iterations=20,
                                                                 reg=0.01))])]


EVALS = {"cls": (_cls_grid, "ClsEvaluation"), "text": (_text_grid, "TextEvaluation")}


@pytest.mark.parametrize("tmpl", sorted(EVALS))
def test_serial_and_distributed_eval_equal_the_jax_packages(home, tmpl, monkeypatch):
    carry_jax_draws(monkeypatch)
    home, _ = home
    grid, ev = EVALS[tmpl]
    jmod, pmod = (jax_cls, port_cls) if tmpl == "cls" else (jax_text, port_text)
    runs = {}
    for dist in (False, True):
        jid, jres = jax_run_evaluation(
            getattr(jmod, ev)(), grid(jmod, JaxEngineParams),
            storage=_jax_storage(home), use_mesh=False, distributed=dist)
        pid, pres = run_evaluation(
            getattr(pmod, ev)(), grid(pmod, EngineParams),
            storage=_port_storage(home), distributed=dist, device="cpu")
        runs["jax", dist] = (jres, jax_lb.read(home, jid))
        runs["port", dist] = (pres, lb.read(home, pid))
    scores = {k: [s for _, s, _ in res.candidates] for k, (res, _) in runs.items()}
    for k in scores:
        assert scores[k] == pytest.approx(scores["jax", False], abs=1e-9), k
    assert {res.best_index for res, _ in runs.values()} == {runs["jax", False][0].best_index}
    assert len({lb.digest(d) for _, d in runs.values()}) == 1
    mine, ref = runs["port", True][1], runs["jax", True][1]
    by_index = {e["index"]: e for e in ref["entries"]}
    for e in mine["entries"]:
        assert e["foldScores"] == pytest.approx(by_index[e["index"]]["foldScores"], abs=1e-9)
    for key in ("buckets", "vmapped", "serial"):
        assert mine[key] == ref[key], key


# -- the CLI ---------------------------------------------------------------------


def test_cli_train_deploy_and_query_match_the_jax_cli(tmp_path, capsys):
    """Twin homes seeded alike: each CLI's ``train`` from its template's
    engine.json, then each instance answered by the port's ``deploy``
    over HTTP and by the JAX package's deploy, all alike."""
    homes = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for name, storage, ev in (("jax", _jax_storage, JaxEvent), ("port", _port_storage, Event)):
        st = storage(homes[name])
        app = st.meta.create_app("MyApp2")
        st.events.init_channel(app.id)
        st.events.insert_batch(_cls_events(ev), app.id)
    code, lines, err = _run(jax_cli.main, jax_registry, _jax_storage(homes["jax"]),
                            ["train", "--engine-dir", os.path.join(
                                REPO, "predictionio_tpu", "templates", "classification"),
                             "--no-mesh"], capsys)
    assert code == 0, err
    engine_dir = os.path.join(REPO, "predictionio_tpu_torch", "templates", "classification")
    code, lines, err = _run(cli.main, port_registry, _port_storage(homes["port"]),
                            ["train", "--engine-dir", engine_dir, "--device", "cpu"], capsys)
    assert code == 0 and "Training completed" in lines[-1], err
    qs = _queries("cls")
    answers = {}
    for name in ("jax", "port"):
        args = cli.build_parser().parse_args([
            "deploy", "--engine-dir", engine_dir, "--ip", "127.0.0.1", "--port", "0",
            "--device", "cpu"])
        port_registry.set_storage(_port_storage(homes[name]))
        try:
            server = cli.make_server(args)
        finally:
            port_registry.set_storage(None)
        with ServerThread(server) as srv:
            got = [request(srv.port, "POST", "/queries.json", q) for q in qs]
        assert all(code == 200 for code, _, _ in got)
        answers[name, "port"] = [body for _, body, _ in got]
        deployed = jax_prepare_deploy(engine_factory=JAX_CLASSIFICATION_FACTORY,
                                      storage=_jax_storage(homes[name]))
        answers[name, "jax"] = [deployed.query(q) for q in qs]
    assert len({json.dumps(a, sort_keys=True) for a in answers.values()}) == 1
