"""The similar-product and e-commerce templates of the port held against
the JAX package's, on the CPU.

One temporary home is seeded through the JAX package's storage with the
two user cliques of ``tests/test_templates.seed_views`` (20 users × 20
items, rank 8, implicit ALS); each package trains each template there.
On it:

- each data source's ``read_training`` gives the JAX one's arrays
  bitwise, with the same id maps and categories;
- the implicit factors agree within 1e-4 (f32 solves in another order,
  ten iterations), the id maps exactly;
- every query shape of ``tests/test_templates.py`` (categories, white
  and black lists, unknown items and users, the popularity cold start,
  ``num`` past the catalog) gets the same answer from both packages, up
  to near-ties within 1e-5, on each package's own instance and on the
  other package's (the blobs carry across both ways; the e-commerce
  blob's pickled params dataclass is named by its JAX module path);
- the live rules (an item made unavailable, an item viewed) reach the
  next answers of both packages alike, and a user whose over-fetch
  passes ``ops.MAX_K`` gets the JAX package's answer (the port's dense
  path);
- ``read_eval``'s folds and ``pio eval``'s HitRate@10 through
  ``run_evaluation`` equal the JAX package's;
- ``similar_items`` on the device path (a CPU tensor takes the plain
  version) equals the host path, and the host path the JAX package's;
- with ``ann: true`` both packages train the PQ index and serve each
  other's instances alike; with ``annShards`` 2 the port serves the
  index unsharded on one slot and item-sharded on two, alike.

Data crosses between the packages as numpy arrays, SQLite rows and
pickled blobs.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jax_als
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.controller.base import WorkflowContext as JaxWorkflowContext
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.ecommercerecommendation import engine as jax_ec
from predictionio_tpu.templates.similarproduct import engine as jax_sp
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.controller import EngineParams, WorkflowContext
from predictionio_tpu_torch.core.workflow import (
    ECOMMERCE_FACTORY,
    JAX_ECOMMERCE_FACTORY,
    JAX_SIMILARPRODUCT_FACTORY,
    SIMILARPRODUCT_FACTORY,
    prepare_deploy,
    run_evaluation,
    run_train,
)
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.ecommercerecommendation import engine as port_ec
from predictionio_tpu_torch.templates.similarproduct import engine as port_sp
from predictionio_tpu_torch.utils.bimap import BiMap
from tests.test_templates import seed_views

TOL = 1e-4        # factors
ANSWER_TOL = 1e-5  # answers: scores, and the width of a near-tie
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALGOS = {"sp": ("als", {"rank": 8, "numIterations": 10}),
         "ec": ("ecomm", {"rank": 8, "numIterations": 10})}
APPS = {"sp": "SPApp", "ec": "ECApp"}
FACTORY = {"sp": (JAX_SIMILARPRODUCT_FACTORY, SIMILARPRODUCT_FACTORY),
           "ec": (JAX_ECOMMERCE_FACTORY, ECOMMERCE_FACTORY)}
MODULES = {"sp": (jax_sp, port_sp), "ec": (jax_ec, port_ec)}

SP_QUERIES = [
    {"items": ["i2", "i3"], "num": 5},
    {"items": ["i2"], "num": 4, "categories": ["books"]},
    {"items": ["i2"], "num": 4, "blackList": ["i3", "i5"]},
    {"items": ["i12"], "num": 4, "whiteList": ["i11", "i13", "i2", "i19"]},
    {"items": ["i1", "i14", "i7"], "num": 6},
    {"items": ["zzz"], "num": 4},
    {"items": ["i2", "zzz"], "num": 3},
    {"items": ["i2", "i3"], "num": 30},
]
EC_QUERIES = [
    {"user": "u1", "num": 3},
    {"user": "u12", "num": 4, "categories": ["electronics"]},
    {"user": "u3", "num": 4, "whiteList": ["i1", "i2", "i13", "i4"]},
    {"user": "u15", "num": 3, "blackList": ["i11", "i14"]},
    {"user": "brand-new-user", "num": 4},
    {"user": "brand-new-user", "num": 4, "categories": ["books"]},
    {"user": "u7", "num": 30},
]


def _jax_storage(home):
    return JaxStorage(JaxStorageConfig(home=home))


def _port_storage(home):
    return Storage(StorageConfig(home=home))


def _variant(kind, factory, **params):
    name, base = ALGOS[kind]
    return {"id": "default", "engineFactory": factory,
            "datasource": {"params": {"appName": APPS[kind]}},
            "algorithms": [{"name": name, "params": dict(base, **params)}]}


def same_answers(a, b, tol=ANSWER_TOL):
    """Equal answers up to near-ties: as long, scores within ``tol``
    position by position, items equal wherever the two scores at that
    position are not within ``tol`` of a neighbour's."""
    a, b = a["itemScores"], b["itemScores"]
    if len(a) != len(b):
        return False
    sa = np.asarray([x["score"] for x in a], np.float64)
    sb = np.asarray([x["score"] for x in b], np.float64)
    finite = np.isfinite(sa) & np.isfinite(sb)
    if not (np.array_equal(np.isfinite(sa), np.isfinite(sb))
            and np.all(np.abs(sa[finite] - sb[finite]) <= tol)):
        return False
    if [x["item"] for x in a] == [x["item"] for x in b]:
        return True
    # differing items only inside a run of near-equal scores
    for j, (x, y) in enumerate(zip(a, b)):
        if x["item"] != y["item"]:
            near = np.abs(sa - sa[j]) <= tol
            if near.sum() < 2 or {z["item"] for z, n in zip(a, near) if n} != \
                    {z["item"] for z, n in zip(b, near) if n}:
                return False
    return True


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """Both apps seeded; each package's instance of each template."""
    home = str(tmp_path_factory.mktemp("pio_templates"))
    js = _jax_storage(home)
    seed_views(js, APPS["sp"])
    seed_views(js, APPS["ec"], with_buys=True)
    ps = _port_storage(home)
    ids = {}
    for kind in ("sp", "ec"):
        jf, pf = FACTORY[kind]
        ids[kind, "jax"] = jax_run_train(jf, variant=_variant(kind, jf), storage=js,
                                         use_mesh=False)
        ids[kind, "port"] = run_train(pf, variant=_variant(kind, pf), storage=ps,
                                      device="cpu")
    return home, ids


def _deployed(home, instance_id, package):
    if package == "jax":
        return jax_prepare_deploy(instance_id=instance_id, storage=_jax_storage(home))
    return prepare_deploy(instance_id=instance_id, storage=_port_storage(home),
                          device="cpu")


@pytest.mark.parametrize("kind", ["sp", "ec"])
def test_read_training_gives_the_jax_arrays(home, kind):
    home, _ = home
    jmod, pmod = MODULES[kind]
    jds = (jmod.SimilarProductDataSource if kind == "sp" else jmod.ECommDataSource)(
        jmod.DataSourceParams(app_name=APPS[kind]))
    pds = (pmod.SimilarProductDataSource if kind == "sp" else pmod.ECommDataSource)(
        pmod.DataSourceParams(app_name=APPS[kind]))
    jtd = jds.read_training(JaxWorkflowContext(storage=_jax_storage(home)))
    ptd = pds.read_training(WorkflowContext(storage=_port_storage(home), device="cpu"))
    for name in ("user_idx", "item_idx") + (("weight",) if kind == "ec" else ()):
        np.testing.assert_array_equal(getattr(ptd, name), getattr(jtd, name))
        assert getattr(ptd, name).dtype == getattr(jtd, name).dtype
    assert ptd.user_ids.to_dict() == jtd.user_ids.to_dict()
    assert ptd.item_ids.to_dict() == jtd.item_ids.to_dict()
    assert ptd.item_categories == jtd.item_categories
    jcoo = (jmod.ALSAlgorithm if kind == "sp" else jmod.ECommAlgorithm)._to_coo(jtd)
    pcoo = (pmod.ALSAlgorithm if kind == "sp" else pmod.ECommAlgorithm)._to_coo(ptd)
    for name in ("user_idx", "item_idx", "rating"):
        np.testing.assert_array_equal(getattr(pcoo, name), getattr(jcoo, name))


@pytest.mark.parametrize("kind", ["sp", "ec"])
def test_implicit_factors_match_the_jax_package(home, kind):
    home, ids = home
    jm = _deployed(home, ids[kind, "jax"], "jax").models[0]
    pm = _deployed(home, ids[kind, "port"], "port").models[0]
    assert pm.item_ids.to_dict() == jm.item_ids.to_dict()
    np.testing.assert_allclose(pm.V, jm.V, rtol=TOL, atol=TOL)
    if kind == "ec":
        assert pm.user_ids.to_dict() == jm.user_ids.to_dict()
        np.testing.assert_allclose(pm.U, jm.U, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(pm.popularity, jm.popularity)
        assert pm.app_name == jm.app_name and pm.item_categories == jm.item_categories


@pytest.mark.parametrize("kind,query", [("sp", q) for q in SP_QUERIES]
                         + [("ec", q) for q in EC_QUERIES])
def test_queries_answer_as_the_jax_package_both_ways(home, kind, query):
    home, ids = home
    ref = _deployed(home, ids[kind, "jax"], "jax").query(dict(query))
    for instance, package in ((ids[kind, "port"], "port"), (ids[kind, "jax"], "port"),
                              (ids[kind, "port"], "jax")):
        got = _deployed(home, instance, package).query(dict(query))
        assert same_answers(got, ref), (instance, package, got, ref)
    if "items" in query:
        assert not set(query["items"]) & {s["item"] for s in ref["itemScores"][:5]}


def test_live_rules_reach_both_packages(tmp_path):
    home = str(tmp_path)
    js = _jax_storage(home)
    seed_views(js, APPS["ec"], with_buys=True)
    iid = jax_run_train(JAX_ECOMMERCE_FACTORY, variant=_variant("ec", JAX_ECOMMERCE_FACTORY),
                        storage=js, use_mesh=False)
    jd, pd = _deployed(home, iid, "jax"), _deployed(home, iid, "port")
    app = js.meta.get_app_by_name(APPS["ec"])
    seen = {e.target_entity_id for e in js.events.find(
        app.id, entity_type="user", entity_id="u1", event_names=["view", "buy"])}
    q = {"user": "u1", "num": 3}
    first = jd.query(dict(q))
    assert same_answers(pd.query(dict(q)), first)
    assert not {s["item"] for s in first["itemScores"]} & seen
    gone = first["itemScores"][0]["item"]
    js.events.insert(JaxEvent(event="$set", entity_type="constraint",
                              entity_id="unavailableItems",
                              properties={"items": [gone]}), app.id)
    second = jd.query(dict(q))
    assert same_answers(pd.query(dict(q)), second)
    assert gone not in {s["item"] for s in second["itemScores"]}
    viewed = second["itemScores"][0]["item"]
    js.events.insert(JaxEvent(event="view", entity_type="user", entity_id="u1",
                              target_entity_type="item", target_entity_id=viewed), app.id)
    third = jd.query(dict(q))
    assert same_answers(pd.query(dict(q)), third)
    assert not {gone, viewed} & {s["item"] for s in third["itemScores"]}
    cold = jd.query({"user": "brand-new-user", "num": 4})
    assert len(cold["itemScores"]) == 4 and gone not in {s["item"] for s in cold["itemScores"]}
    assert same_answers(pd.query({"user": "brand-new-user", "num": 4}), cold)


def test_over_fetch_past_max_k_takes_the_dense_path(tmp_path, monkeypatch):
    """A user who has seen more than ops.MAX_K items: the port's k passes
    the kernel's limit and takes the JAX package's dense path; both
    packages give the same answer."""
    from predictionio_tpu_torch import ops

    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    home = str(tmp_path)
    js = _jax_storage(home)
    app = js.meta.create_app("BigApp")
    js.events.init_channel(app.id)
    n_items, n_seen = 3000, ops.MAX_K + 100
    js.events.insert_batch([JaxEvent(event="view", entity_type="user", entity_id="u0",
                                     target_entity_type="item", target_entity_id=f"i{i}")
                            for i in range(0, 2 * n_seen, 2)], app.id)
    rng = np.random.default_rng(4)
    U = rng.standard_normal((3, 8)).astype(np.float32)
    V = rng.standard_normal((n_items, 8)).astype(np.float32)
    pop = rng.integers(0, 50, n_items).astype(np.float32)
    cats = {f"i{i}": ["books" if i % 3 else "toys"] for i in range(n_items)}
    uids = {f"u{u}": u for u in range(3)}
    iids = {f"i{i}": i for i in range(n_items)}
    jm = jax_ec.ECommModel(U, V, JaxBiMap(uids), JaxBiMap(iids), cats, pop, "BigApp",
                           jax_ec.ECommAlgorithmParams())
    pm = port_ec.ECommModel(U, V, BiMap(uids), BiMap(iids), cats, pop, "BigApp",
                            port_ec.ECommAlgorithmParams(), device="cpu")
    calls = {"kernel": 0}
    real = ops.score_topk

    def counting(*a, **k):
        calls["kernel"] += 1
        return real(*a, **k)

    monkeypatch.setattr(ops, "score_topk", counting)
    for q in ({"num": 10}, {"num": 5, "categories": ["toys"]}):
        want = jm.query("u0", storage=js, **q)
        got = pm.query("u0", storage=_port_storage(home), **q)
        assert same_answers({"itemScores": got}, {"itemScores": want}), (got, want)
        assert not {f"i{i}" for i in range(0, 2 * n_seen, 2)} & {s["item"] for s in got}
    assert calls["kernel"] == 0  # k > MAX_K: the dense path, never the kernel
    assert pm.query("u1", num=10, storage=_port_storage(home))  # k <= MAX_K
    assert calls["kernel"] == 1


@pytest.mark.parametrize("kind", ["sp", "ec"])
def test_read_eval_and_pio_eval_score_as_the_jax_package(tmp_path, kind):
    home = str(tmp_path)
    js = _jax_storage(home)
    if kind == "sp":
        # shuffled per-user order, as tests/test_templates.py's eval test
        app = js.meta.create_app(APPS[kind])
        js.events.init_channel(app.id)
        rng = np.random.default_rng(0)
        evs = []
        for u in range(20):
            lo, hi = (0, 10) if u < 10 else (10, 20)
            items = [i for i in range(lo, hi) if rng.random() < 0.7]
            rng.shuffle(items)
            evs += [JaxEvent(event="view", entity_type="user", entity_id=f"u{u}",
                             target_entity_type="item", target_entity_id=f"i{i}")
                    for i in items]
        js.events.insert_batch(evs, app.id)
    else:
        seed_views(js, APPS[kind], with_buys=True)
    jmod, pmod = MODULES[kind]
    name = ALGOS[kind][0]
    jparams = jmod.ALSAlgorithmParams if kind == "sp" else jmod.ECommAlgorithmParams
    pparams = pmod.ALSAlgorithmParams if kind == "sp" else pmod.ECommAlgorithmParams
    extra = {} if kind == "sp" else {"unseen_only": False}
    grid = [dict(rank=r, num_iterations=10, **extra) for r in (4, 8)]
    jc = [JaxEngineParams(data_source_params=jmod.DataSourceParams(app_name=APPS[kind]),
                          algorithms_params=[(name, jparams(**g))]) for g in grid]
    pc = [EngineParams(data_source_params=pmod.DataSourceParams(app_name=APPS[kind]),
                       algorithms_params=[(name, pparams(**g))]) for g in grid]
    jds = jmod.engine_factory().data_source_cls(jc[0].data_source_params)
    pds = pmod.engine_factory().data_source_cls(pc[0].data_source_params)
    [(jtd, jinfo, jqa)] = jds.read_eval(JaxWorkflowContext(storage=js))
    [(ptd, pinfo, pqa)] = pds.read_eval(WorkflowContext(storage=_port_storage(home),
                                                        device="cpu"))
    assert pinfo == jinfo and pqa == jqa
    np.testing.assert_array_equal(ptd.user_idx, jtd.user_idx)
    np.testing.assert_array_equal(ptd.item_idx, jtd.item_idx)
    jev = (jmod.SPEvaluation if kind == "sp" else jmod.ECommEvaluation)()
    pev = (pmod.SPEvaluation if kind == "sp" else pmod.ECommEvaluation)()
    # the live rules read the process's default storage during eval (no
    # serving context is set there), in both packages
    ps = _port_storage(home)
    jax_registry.set_storage(js)
    port_registry.set_storage(ps)
    try:
        _, jres = jax_run_evaluation(jev, jc, storage=js, use_mesh=False)
        _, pres = run_evaluation(pev, pc, storage=ps, device="cpu")
    finally:
        jax_registry.set_storage(None)
        port_registry.set_storage(None)
    assert pev.metric.header == jev.metric.header == "HitRate@10"
    assert [s for _, s, _ in pres.candidates] == [s for _, s, _ in jres.candidates]
    assert pres.best_index == jres.best_index and pres.best_score > 0.5


def test_ecommerce_blob_params_cross_both_ways(home):
    """The blob's params dataclass: a port blob names the JAX module path
    (the JAX package unpickles its own class, no torch); a JAX blob loads
    into the port's class; the port refuses any other JAX name."""
    home, ids = home
    pm = _deployed(home, ids["ec", "port"], "port").models[0]
    params = port_ec.ECommAlgorithmParams(rank=8, num_iterations=10, seed=5,
                                          unseen_only=False, seen_events=["view"])
    blob = port_ec.ECommAlgorithm(params).save_model(pm, None)
    assert b"predictionio_tpu.templates.ecommercerecommendation.engine" in blob
    assert b"predictionio_tpu_torch" not in blob
    d = pickle.loads(blob)
    assert type(d["params"]) is jax_ec.ECommAlgorithmParams
    assert vars(d["params"]) == vars(params)
    jm = jax_ec.ECommAlgorithm(d["params"]).load_model(blob, None)
    np.testing.assert_array_equal(jm.U, pm.U)
    jblob = jax_ec.ECommAlgorithm(d["params"]).save_model(jm, None)
    back = port_ec.ECommAlgorithm(params).load_model(jblob, None)
    assert type(back.params) is port_ec.ECommAlgorithmParams
    assert vars(back.params) == vars(params)
    np.testing.assert_array_equal(back.V, pm.V)
    evil = pickle.dumps({"params": jax_als.ALSParams()})
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        port_ec.loads_blob(evil)


def test_the_port_loads_a_jax_ecommerce_blob_without_the_jax_package(home, tmp_path):
    home, ids = home
    raw = _jax_storage(home).models.get(ids["ec", "jax"])
    path = tmp_path / "model.bin"
    path.write_bytes(pickle.loads(raw)[0])
    code = (
        "import sys, numpy as np\n"
        "from predictionio_tpu_torch.templates.ecommercerecommendation import engine as e\n"
        f"m = e.ECommAlgorithm().load_model(open({str(path)!r}, 'rb').read(), None)\n"
        "assert type(m.params) is e.ECommAlgorithmParams, type(m.params)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('predictionio_tpu.')]\n"
        "print(m.params.rank, m.U.shape, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("8 (20, 8)")


def test_ann_is_refused_at_train_and_at_load(tmp_path, monkeypatch):
    """ANN on the similar-product template (the name dates from when the
    port refused it): both packages train ``ann: true`` on a home of their own (rank
    8, annM 4, the index over the normalised factors, its sidecar beside
    model.bin);
    each package serves each instance, single-item queries through the
    ANN scorer, with the JAX package's answers on its own instance up to
    near-ties, and the blob's index bytes serve without the sidecar. With
    ``annShards`` 2 both record the hint in the index; the port serves it
    unsharded on one CPU slot and item-sharded on two, alike."""
    from predictionio_tpu_torch.ann import ANNScorer, INDEX_BASENAME, ShardedANNScorer
    from predictionio_tpu_torch.parallel import distributed

    home = str(tmp_path / "ann_home")
    seed_views(_jax_storage(home), APPS["sp"])
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    pf, jf = SIMILARPRODUCT_FACTORY, JAX_SIMILARPRODUCT_FACTORY
    ann = dict(ann=True, annM=4)
    ids = {"jax": jax_run_train(jf, variant=dict(_variant("sp", jf, **ann), id="ann"),
                                storage=_jax_storage(home), use_mesh=False),
           "port": run_train(pf, variant=dict(_variant("sp", pf, **ann), id="ann"),
                             storage=_port_storage(home), device="cpu")}
    for iid in ids.values():
        algo_dir = os.path.join(_port_storage(home).models.model_dir(iid), "als")
        assert os.path.isfile(os.path.join(algo_dir, INDEX_BASENAME))
    ref = {q: _deployed(home, ids["jax"], "jax").query({"items": [q], "num": 5})
           for q in ("i2", "i13", "i7")}
    for iid in ids.values():
        for package in ("jax", "port"):
            dep = _deployed(home, iid, package)
            if package == "port":
                assert dep.models[0].ann_index is not None
                assert isinstance(dep.models[0]._ann_device_scorer(), ANNScorer)
            for q, want in ref.items():
                got = dep.query({"items": [q], "num": 5})
                assert same_answers(got, want, TOL), (iid, package, got, want)
                assert q not in {s["item"] for s in got["itemScores"]}
            multi = {"items": ["i2", "i3"], "num": 5}
            assert same_answers(dep.query(multi),
                                _deployed(home, ids["jax"], "jax").query(multi), TOL)
    # the JAX package's engine.json (ANN params included) parses
    with open(os.path.join(REPO, "predictionio_tpu", "templates", "similarproduct",
                           "engine.json")) as f:
        ep = port_sp.engine_factory().params_from_variant(json.load(f))
    assert ep.algorithms_params[0][1].ann_shortlist == 128
    blob = pickle.loads(_port_storage(home).models.get(ids["port"]))[0]
    algo = port_sp.ALSAlgorithm(port_sp.ALSAlgorithmParams())
    algo.device = "cpu"
    model = algo.load_model(blob, None)          # the blob's own index bytes
    assert model.V.shape == (20, 8) and model.ann_index is not None
    # annShards 2: the hint rides in the index, as the JAX package's
    # does; one CPU slot serves it unsharded, two item-sharded, alike
    sharded = {"jax": jax_run_train(jf, variant=dict(_variant("sp", jf, annShards=2, **ann),
                                                     id="ann2"),
                                    storage=_jax_storage(home), use_mesh=False),
               "port": run_train(pf, variant=dict(_variant("sp", pf, annShards=2, **ann),
                                                  id="ann2"),
                                 storage=_port_storage(home), device="cpu")}
    for iid in sharded.values():
        one = _deployed(home, iid, "port")
        assert one.models[0].ann_index.meta.get("shards") == 2
        assert type(one.models[0]._ann_device_scorer()) is ANNScorer
        distributed.initialize(slots=["cpu"] * 2)
        try:
            two = _deployed(home, iid, "port")
            assert type(two.models[0]._ann_device_scorer()) is ShardedANNScorer
            for q in ref:
                want = one.query({"items": [q], "num": 5})
                assert two.query({"items": [q], "num": 5}) == want
                assert same_answers(want, _deployed(home, iid, "jax").query(
                    {"items": [q], "num": 5}), TOL)
        finally:
            distributed.shutdown()
    assert algo.load_model(pickle.dumps(dict(pickle.loads(blob), ann_shards=2)),
                           None).ann_shards == 2


def test_similar_items_device_path_equals_host_path(monkeypatch):
    rng = np.random.default_rng(9)
    V = rng.standard_normal((3000, 8)).astype(np.float32)
    V[17] = 0.0  # a zero row stays a zero direction
    monkeypatch.delenv("PIO_ALS_SERVE", raising=False)
    Vn = port_als.normalized_rows(V)
    assert port_als.maybe_resident_scorer(Vn[:100], Vn[:100], device="cpu") is None
    scorer = port_als.maybe_resident_scorer(Vn, Vn, device="cpu")
    assert isinstance(scorer, port_als.ResidentScorer)
    assert port_als.maybe_resident_scorer(Vn, Vn, scorer, device="cpu") is scorer
    monkeypatch.setenv("PIO_ALS_SERVE", "host")
    assert port_als.maybe_resident_scorer(Vn, Vn, device="cpu") is None
    for idx, num in (([3], 10), ([3, 40, 41], 50), ([5, 5, 9], 7), ([17, 2], 20),
                     (list(range(20)), 1100)):
        idx = np.asarray(idx, np.int32)
        ht, hs = port_als.similar_items(V, idx, num)
        jt, js_ = jax_als.similar_items(V, idx, num)
        np.testing.assert_array_equal(ht, jt)
        np.testing.assert_allclose(hs, js_, rtol=1e-6)
        dt, ds = port_als.similar_items_device(scorer, Vn, idx, num)
        assert not set(idx.tolist()) & set(dt.tolist())
        host = {"itemScores": [{"item": int(i), "score": float(s)} for i, s in zip(ht, hs)]}
        dev = {"itemScores": [{"item": int(i), "score": float(s)} for i, s in zip(dt, ds)]}
        assert same_answers(dev, host), idx


def test_similar_product_model_serves_through_the_device_path(home, monkeypatch):
    """PIO_ALS_SERVE=device: the template's answers on the device path
    (the plain version on a CPU tensor) equal its host answers."""
    home, ids = home
    host = _deployed(home, ids["sp", "port"], "port")
    monkeypatch.setenv("PIO_ALS_SERVE", "device")
    dev = _deployed(home, ids["sp", "port"], "port")
    for q in SP_QUERIES[:-1]:
        assert same_answers(dev.query(dict(q)), host.query(dict(q))), q
    assert isinstance(dev.models[0]._scorer, port_als.ResidentScorer)


def test_instances_record_the_jax_factory_and_resolve_either_name(home):
    home, ids = home
    ps = _port_storage(home)
    for kind in ("sp", "ec"):
        jf, pf = FACTORY[kind]
        assert ps.meta.get_engine_instance(ids[kind, "port"]).engine_factory == jf
        for name in (jf, pf):
            d = prepare_deploy(engine_factory=name, storage=ps, device="cpu")
            assert d.instance.id in (ids[kind, "jax"], ids[kind, "port"])


def test_templates_train_on_no_card_only_when_asked(home, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    home, _ = home
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(SIMILARPRODUCT_FACTORY, variant=_variant("sp", SIMILARPRODUCT_FACTORY),
                  storage=_port_storage(home))
