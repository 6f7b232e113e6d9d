"""The port's CCO (co-occurrence with LLR indicators), its resident
scorer and the Universal Recommender template held against the JAX
package's, on the CPU.

- the host stages (downsampling, CSR, the sparse counts, the float64
  LLR, the sparse top-k, ``score_user``) are copies and give bitwise the
  same arrays;
- the dense counts on the device equal the JAX package's bit for bit
  (0/1 products: integers, exact in any summation order);
- the dense f32 LLR is within ``LLR_TOL`` of the JAX package's, relative
  to the formula's term scale ``2·n·ln n`` (the LLR is a difference of
  terms that large, so f32 rounding — XLA's ``log`` is not torch's, and
  XLA contracts products into FMAs — moves small values by an absolute
  amount of that order; both packages are as far from float64), and the
  top-k indices are ``lax.top_k``'s up to near-ties between distinct
  counts within that tolerance: exact ties lowest column first,
  rows with fewer than k live entries filled with ``-inf`` at the lowest
  free columns, the diagonal masked, a threshold applied;
- ``cco_indicators`` and ``cco_indicators_many`` on the dense and the
  sparse path, and ``CCOResidentScorer.recommend`` with boosts, bans,
  popularity ties and the history buckets, answer alike;
- ``read_training_event_groups`` reads one event store alike;
- on one home both packages train the template; each package serves
  each instance (the blobs cross both ways) with the same answers, and
  the leave-one-out MAP@10 of ``pio eval`` is equal.
"""

import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data import store as jax_store
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.models import cco as jax_cco
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.universal import engine as jax_engine
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.core.workflow import (
    JAX_UNIVERSAL_FACTORY,
    UNIVERSAL_FACTORY,
    prepare_deploy,
    run_evaluation,
    run_train,
)
from predictionio_tpu_torch.data import store as port_store
from predictionio_tpu_torch.models import cco as port_cco
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.universal import engine as port_engine
from predictionio_tpu_torch.utils import jaxpickle
from predictionio_tpu_torch.utils.bimap import BiMap

LLR_TOL = 1e-5     # dense LLR values, of the term scale 2·n·ln n
SCORE_TOL = 1e-5   # served scores, relative; and the width of a near-tie


def _data(seed, n_users=300, n_a=80, n_b=60, nnz=6000):
    """Zipf-skewed primary and secondary pairs (repeats included)."""
    rng = np.random.default_rng(seed)
    prim = (rng.integers(0, n_users, nnz).astype(np.int32),
            (rng.zipf(1.5, nnz) % n_a).astype(np.int32))
    sec = (rng.integers(0, n_users, nnz).astype(np.int32),
           (rng.zipf(1.3, nnz) % n_b).astype(np.int32))
    return prim, sec, n_users, n_a, n_b


def _csrs(seed):
    prim, sec, n_users, n_a, n_b = _data(seed)
    return (jax_cco._csr_from_pairs(*prim, n_users, n_a),
            jax_cco._csr_from_pairs(*sec, n_users, n_b), n_users, n_a, n_b)


def _assert_llr_equal(j, p, n_users):
    """Values within LLR_TOL of the term scale position by position,
    finite where the JAX values are, and indices equal except where two
    columns' values lie within that tolerance of each other (a near-tie
    between distinct counts, which rounding may order either way);
    exact ties keep ``lax.top_k``'s order."""
    (ji, jv), (pi, pv) = j, p
    tol = LLR_TOL * 2.0 * n_users * np.log(n_users)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(pv), fin)
    np.testing.assert_array_equal(pv[~fin], jv[~fin])
    assert np.abs(pv[fin] - jv[fin]).max(initial=0.0) <= tol
    for r, c in zip(*np.nonzero(pi != ji)):
        assert fin[r, c], "a swap among the -inf fill"
        # the port's column at this position: its JAX value (when JAX
        # kept it) is near-tied with JAX's value here
        where = np.nonzero(ji[r] == pi[r, c])[0]
        if where.size:
            assert abs(jv[r, where[0]] - jv[r, c]) <= 2 * tol
        else:   # cut at the k-th: JAX's last kept value is near-tied
            assert abs(jv[r, -1] - pv[r, c]) <= 2 * tol


# -- the host stages: copies, bitwise ----------------------------------------


@pytest.mark.parametrize("cap", [0, 3, 20, 10_000])
def test_downsampling_and_csr_are_bitwise_the_jax_packages(cap):
    prim, _, n_users, n_a, _ = _data(1)
    ju, ji = jax_cco._downsample_per_user(*prim, cap)
    pu, pi = port_cco._downsample_per_user(*prim, cap)
    np.testing.assert_array_equal(pu, ju)
    np.testing.assert_array_equal(pi, ji)
    for a, b in zip(port_cco._csr_from_pairs(pu, pi, n_users, n_a),
                    jax_cco._csr_from_pairs(ju, ji, n_users, n_a)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("budget", [7, 500, 8_000_000])
def test_sparse_counts_llr_and_topk_are_bitwise_the_jax_packages(budget):
    p, s, n_users, n_a, n_b = _csrs(2)
    ref = jax_cco._cooccurrence_sparse(p, s, n_users, n_b, budget=budget)
    got = port_cco._cooccurrence_sparse(p, s, n_users, n_b, budget=budget)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rows, cols, cnts = ref
    rc = np.bincount(p[1], minlength=n_a).astype(np.float32)
    cc = np.bincount(s[1], minlength=n_b).astype(np.float32)
    np.testing.assert_array_equal(
        port_cco._llr_values(cnts, rc[rows], cc[cols], n_users),
        jax_cco._llr_values(cnts, rc[rows], cc[cols], n_users))
    for k, thr, same in ((5, 0.0, False), (70, 1.5, False), (8, 0.0, True)):
        for a, b in zip(port_cco._llr_topk_sparse(rows, cols, cnts, rc, cc, n_users, n_a,
                                                  n_b, k, thr, same),
                        jax_cco._llr_topk_sparse(rows, cols, cnts, rc, cc, n_users, n_a,
                                                 n_b, k, thr, same)):
            np.testing.assert_array_equal(a, b)


def test_score_user_is_bitwise_the_jax_packages():
    rng = np.random.default_rng(4)
    ind = {}
    for name in ("buy", "view"):
        vals = rng.uniform(0.5, 9.0, (40, 5)).astype(np.float32)
        vals[rng.random((40, 5)) < 0.3] = -np.inf
        ind[name] = (rng.integers(0, 40, (40, 5)).astype(np.int32), vals)
    for hist, boosts in (({"buy": [1, 4, 9], "view": [2]}, {"view": 0.5}),
                         ({"view": [3, 3, 7]}, None), ({"other": [1]}, None), ({}, None)):
        np.testing.assert_array_equal(port_cco.score_user(ind, hist, 40, boosts),
                                      jax_cco.score_user(ind, hist, 40, boosts))


# -- the device stages ---------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 64, 77, 4096])
def test_dense_counts_are_bitwise_the_jax_packages(chunk):
    p, s, n_users, n_a, n_b = _csrs(3)
    for sec, width in ((s, n_b), (p, n_a)):
        want = jax_cco._cooccurrence(p, sec, n_users, n_a, width, chunk)
        got = port_cco._cooccurrence(p, sec, n_users, n_a, width, chunk, "cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,threshold,same,row_block", [
    (10, 0.0, False, 4096), (10, 0.0, False, 7), (30, 2.0, False, 32),
    (60, 0.0, False, 64),           # k = n_b: every row -inf-filled
    (12, 0.0, True, 16), (80, 0.0, True, 4096), (5, 50.0, True, 33)])
def test_llr_topk_equals_lax_top_k(k, threshold, same, row_block):
    p, s, n_users, n_a, n_b = _csrs(3)
    sec, width = (p, n_a) if same else (s, n_b)
    C = jax_cco._cooccurrence(p, sec, n_users, n_a, width, 64)
    rc = np.bincount(p[1], minlength=n_a).astype(np.float32)
    cc = np.bincount(sec[1], minlength=width).astype(np.float32)
    want = jax_cco._llr_topk(C, rc, cc, n_users, k, threshold, row_block, same)
    got = port_cco._llr_topk(torch.from_numpy(C), rc, cc, n_users, k, threshold,
                             row_block, same)
    _assert_llr_equal(want, got, n_users)
    if same:
        rows = np.arange(n_a)[:, None]
        assert not ((got[0] == rows) & np.isfinite(got[1])).any()
    if threshold:
        assert (got[1][np.isfinite(got[1])] >= threshold).all()


def test_planted_ties_come_lowest_column_first():
    """Items 0-3 are bought by the same users, items 4-11 by the same
    others, so each row's LLRs tie exactly in groups; a row with fewer
    live entries than k is filled with -inf at the lowest free columns."""
    users, items = [], []
    for u in range(12):
        for i in (range(0, 4) if u < 6 else range(4, 12)):
            users.append(u)
            items.append(i)
    for u in range(12, 40):
        users.append(u)
        items.append(12 + u % 3)
    pairs = (np.asarray(users, np.int32), np.asarray(items, np.int32))
    n_users, n = 40, 15
    for k in (4, 9, 15):
        want = jax_cco.cco_indicators(pairs, {"p": pairs}, n_users, n, {"p": n},
                                      jax_cco.CCOParams(max_indicators_per_item=k))
        got = port_cco.cco_indicators(pairs, {"p": pairs}, n_users, n, {"p": n},
                                      port_cco.CCOParams(max_indicators_per_item=k),
                                      device="cpu")
        _assert_llr_equal(want["p"], got["p"], n_users)
        idx, val = got["p"]
        assert idx[0, :3].tolist() == [1, 2, 3] and len(set(val[0, :3].tolist())) == 1
        assert idx[5, :min(k, 7)].tolist() == [4, 6, 7, 8, 9, 10, 11][:k]
        if k == 15:   # -inf fill at the lowest free columns, row 0's own first
            assert not np.isfinite(val[0, 3:]).any()
            assert idx[0, 3:].tolist() == [0] + list(range(4, 15))


@pytest.mark.parametrize("dense_mb", [1024, 0])
def test_cco_indicators_and_many_answer_alike(dense_mb):
    prim, sec, n_users, n_a, _ = _data(6, n_b=80)
    ev = {"buy": prim, "view": sec}
    widths = {"buy": n_a, "view": n_a}
    grid = [dict(max_indicators_per_item=k, llr_threshold=t, dense_c_max_mb=dense_mb,
                 max_interactions_per_user=cap)
            for k, t, cap in ((5, 0.0, 500), (9, 1.0, 500), (5, 0.0, 10))]
    jmany = jax_cco.cco_indicators_many(prim, ev, n_users, n_a, widths,
                                        [jax_cco.CCOParams(**g) for g in grid])
    pmany = port_cco.cco_indicators_many(prim, ev, n_users, n_a, widths,
                                         [port_cco.CCOParams(**g) for g in grid],
                                         device="cpu")
    for g, j, p in zip(grid, jmany, pmany):
        one = port_cco.cco_indicators(prim, ev, n_users, n_a, widths,
                                      port_cco.CCOParams(**g), device="cpu")
        for name in ev:
            if dense_mb:
                _assert_llr_equal(j[name], p[name], n_users)
            else:   # the sparse path is host numpy: bitwise
                for a, b in zip(p[name], j[name]):
                    np.testing.assert_array_equal(a, b)
            for a, b in zip(one[name], p[name]):
                np.testing.assert_array_equal(a, b)


def test_counts_are_built_once_per_count_group(monkeypatch):
    prim, sec, n_users, n_a, _ = _data(7, n_b=80)
    calls = []
    orig = port_cco._cooccurrence
    monkeypatch.setattr(port_cco, "_cooccurrence",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    grid = [port_cco.CCOParams(max_indicators_per_item=k, llr_threshold=t, row_block=rb)
            for k, t, rb in ((3, 0.0, 16), (5, 1.0, 4096))]
    port_cco.cco_indicators_many(prim, {"buy": prim, "view": sec}, n_users, n_a,
                                 {"buy": n_a, "view": n_a}, grid, device="cpu")
    assert len(calls) == 2   # one per event, shared by both candidates


def test_the_dense_path_needs_a_card_or_a_cpu_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prim, _, n_users, n_a, _ = _data(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cco.cco_indicators(prim, {"p": prim}, n_users, n_a, {"p": n_a})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cco.CCOResidentScorer({}, 3, np.zeros(3, np.float32))


# -- the resident scorer ---------------------------------------------------------


def _indicators(seed, n_items=50, k=6, quarter=False):
    rng = np.random.default_rng(seed)
    ind = {}
    for name in ("buy", "view"):
        idxs = rng.integers(0, n_items, (n_items, k)).astype(np.int32)
        vals = rng.uniform(0.5, 9.0, (n_items, k)).astype(np.float32)
        if quarter:   # exact sums in any order: scores tie across items
            vals = np.round(vals * 4) / 4
        vals[rng.random((n_items, k)) < 0.3] = -np.inf
        ind[name] = (idxs, vals)
    return ind


SCORER_QUERIES = [
    ({"buy": [3, 7, 11], "view": [2, 3]}, 10, {"view": 0.5}, []),
    ({"buy": [3, 7, 11], "view": [2, 3]}, 10, {"view": 0.5}, [5, 9, 30]),
    ({}, 5, None, [1, 2]),                                 # cold: popularity
    ({"buy": list(range(40))}, 20, {"buy": -1.0}, []),     # no score > 0
    ({"view": list(range(17))}, 30, None, list(range(20))),  # H = 32, k = 64
    ({"view": [1]}, 3, None, [4]),
    ({"buy": [0, 1, 2, 3, 4, 5]}, 100, {"buy": 2.0, "view": 0.0}, []),
    ({"unknown": [1, 2]}, 4, None, []),
]


@pytest.mark.parametrize("quarter", [False, True])
@pytest.mark.parametrize("query", range(len(SCORER_QUERIES)))
def test_resident_scorer_answers_as_the_jax_packages(quarter, query):
    ind = _indicators(3, quarter=quarter)
    pop = np.random.default_rng(9).integers(0, 4, 50).astype(np.float32)  # ties
    hist, num, boosts, banned = SCORER_QUERIES[query]
    want = jax_cco.CCOResidentScorer(ind, 50, pop).recommend(hist, num, boosts, banned)
    got = port_cco.CCOResidentScorer(ind, 50, pop, device="cpu").recommend(
        hist, num, boosts, banned)
    if quarter:   # sums exact in any order: bitwise, ties by index
        assert got == want
    else:         # the row sums' order differs: near-ties may swap
        _agree({"itemScores": [{"item": i, "score": v} for i, v in want]},
               {"itemScores": [{"item": i, "score": v} for i, v in got]})
    assert not set(banned) & {i for i, _ in got}


def test_resident_scorer_refuses_a_catalog_of_2_24_items():
    with pytest.raises(ValueError, match="2\\^24"):
        port_cco.CCOResidentScorer({}, 1 << 24, np.zeros(1, np.float32), device="cpu")


# -- the event read ------------------------------------------------------------


def _events(rng, n=600):
    evs = []
    for j in range(n):
        u, i = int(rng.integers(0, 30)), int(rng.integers(0, 25))
        name = ("buy", "view", "rate")[int(rng.integers(0, 3))]
        evs.append(JaxEvent(event=name, entity_type="user", entity_id=f"u{u}",
                            target_entity_type="item", target_entity_id=f"i{i}"))
    # events without a target, and of another entity type, are skipped
    evs.append(JaxEvent(event="buy", entity_type="user", entity_id="lonely"))
    evs.append(JaxEvent(event="view", entity_type="shop", entity_id="s1",
                        target_entity_type="item", target_entity_id="i99"))
    return evs


@pytest.mark.parametrize("chunk", [7, 65536])
def test_read_training_event_groups_reads_the_store_alike(tmp_path, chunk):
    home = str(tmp_path)
    js = JaxStorage(JaxStorageConfig(home=home))
    app = js.meta.create_app("GroupsApp")
    js.events.init_channel(app.id)
    js.events.insert_batch(_events(np.random.default_rng(2)), app.id)
    names = ["buy", "view", "none"]
    jp, ju, ji = jax_store.read_training_event_groups("GroupsApp", names, storage=js,
                                                      chunk_size=chunk)
    pp, pu, pi = port_store.read_training_event_groups(
        "GroupsApp", names, storage=Storage(StorageConfig(home=home)), chunk_size=chunk)
    assert list(pp) == names and pu.to_dict() == ju.to_dict() and pi.to_dict() == ji.to_dict()
    for n in names:
        for a, b in zip(pp[n], jp[n]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert pp["none"][0].size == 0 and pp["buy"][0].size > 100


# -- the template on one home --------------------------------------------------


def _seed_ur(storage, app_name="URApp"):
    """Two cliques of 20 users over 12 items each, views and buys."""
    app = storage.meta.create_app(app_name)
    storage.events.init_channel(app.id)
    rng = np.random.default_rng(3)
    evs = []
    for u in range(40):
        lo = 0 if u < 20 else 12
        for i in range(lo, lo + 12):
            if rng.random() < 0.6:
                evs.append(JaxEvent(event="view", entity_type="user", entity_id=f"u{u}",
                                    target_entity_type="item", target_entity_id=f"i{i}"))
            if rng.random() < 0.35:
                evs.append(JaxEvent(event="buy", entity_type="user", entity_id=f"u{u}",
                                    target_entity_type="item", target_entity_id=f"i{i}"))
    storage.events.insert_batch(evs, app.id)


def _variant(factory):
    return {"engineFactory": factory,
            "datasource": {"params": {"appName": "URApp", "eventNames": ["buy", "view"]}},
            "algorithms": [{"name": "ur", "params": {"maxIndicatorsPerItem": 6,
                                                     "eventBoosts": {"view": 0.5}}}]}


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    home = str(tmp_path_factory.mktemp("pio_universal"))
    js = JaxStorage(JaxStorageConfig(home=home))
    _seed_ur(js)
    ids = {"jax": jax_run_train(JAX_UNIVERSAL_FACTORY, variant=_variant(JAX_UNIVERSAL_FACTORY),
                                storage=js, use_mesh=False),
           "port": run_train(UNIVERSAL_FACTORY, variant=_variant(UNIVERSAL_FACTORY),
                             storage=Storage(StorageConfig(home=home)), device="cpu")}
    return home, ids


def _agree(a, b):
    """Equal up to near-ties: the same length, scores within SCORE_TOL
    (relative, at least of 1) position by position, and where the items
    differ, the other's item is near-tied with this position's score in
    ``a`` (a swap) or, absent from ``a``, with ``a``'s last (a cut)."""
    sa, sb = a["itemScores"], b["itemScores"]
    assert len(sa) == len(sb)
    tol = [SCORE_TOL * max(abs(x["score"]), 1.0) for x in sa]
    for x, y, t in zip(sa, sb, tol):
        assert abs(x["score"] - y["score"]) <= t
    where = {x["item"]: j for j, x in enumerate(sa)}
    for j, (x, y) in enumerate(zip(sa, sb)):
        if x["item"] != y["item"]:
            ref = sa[where[y["item"]]]["score"] if y["item"] in where else sa[-1]["score"]
            assert abs(ref - x["score"]) <= 2 * tol[j], (j, x, y)
    assert len({y["item"] for y in sb}) == len(sb)


UR_QUERIES = [{"user": "u1", "num": 5}, {"user": "u25", "num": 8},
              {"user": "u3", "num": 4, "eventBoosts": {"view": 2.0, "buy": 1.0}},
              {"user": "u30", "num": 6, "blackList": ["i14", "i15"]},
              {"user": "nobody", "num": 3}, {"item": "i0", "num": 4},
              {"item": "i20", "num": 10}, {"item": "unknown", "num": 3},
              {"user": "u7", "num": 30}]


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_each_package_serves_each_instance_alike(home, trained_by):
    home, ids = home
    jd = jax_prepare_deploy(instance_id=ids[trained_by],
                            storage=JaxStorage(JaxStorageConfig(home=home)))
    pd = prepare_deploy(instance_id=ids[trained_by], storage=Storage(StorageConfig(home=home)),
                        device="cpu")
    assert isinstance(pd.models[0], port_engine.URModel)
    for q in UR_QUERIES:
        _agree(pd.query(q), jd.query(q))
    own = pd.query({"user": "u1", "num": 5})["itemScores"]
    assert own and all(int(s["item"][1:]) < 12 for s in own)
    assert pd.query({"item": "unknown", "num": 3}) == {"itemScores": []}


def test_both_packages_train_the_same_indicators(home):
    home, ids = home
    port_model = pickle.loads(Storage(StorageConfig(home=home)).models.get(ids["port"]))[0]
    jax_model = pickle.loads(JaxStorage(JaxStorageConfig(home=home)).models.get(ids["jax"]))[0]
    p = port_engine.loads_blob(port_model)
    j = port_engine.loads_blob(jax_model)
    assert p.user_history == j.user_history and p.item_ids.to_dict() == j.item_ids.to_dict()
    np.testing.assert_array_equal(p.popularity, j.popularity)
    n_users = len(p.user_history)
    for name in ("buy", "view"):
        _assert_llr_equal(j.indicators[name], p.indicators[name], n_users)


def test_blob_crosses_both_ways(home):
    home, ids = home
    port_blob = pickle.loads(Storage(StorageConfig(home=home)).models.get(ids["port"]))[0]
    m = pickle.loads(port_blob)      # the JAX package's own unpickler
    assert type(m) is jax_engine.URModel and type(m.item_ids) is JaxBiMap
    assert type(m.params) is jax_engine.URAlgorithmParams and m.params.max_indicators_per_item == 6
    assert m._scorer is None and not hasattr(m, "_device")
    assert m.query_user("u1", 5) and m.scorer is not None
    again = pickle.dumps(m)          # a JAX blob of it, back in the port
    algo = port_engine.URAlgorithm(port_engine.URAlgorithmParams())
    algo.device = torch.device("cpu")
    back = algo.load_model(again, None)
    assert type(back) is port_engine.URModel and type(back.item_ids) is BiMap
    assert back.query_user("u1", 5) == m.query_user("u1", 5)
    assert back.query_item("i3", 4) == m.query_item("i3", 4)
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        port_engine.loads_blob(pickle.dumps(jax_engine.DataSourceParams()))
    # a mapped class inside a container written by the C pickler is refused
    inner = {"ids": back.item_ids}
    with pytest.raises(pickle.PicklingError, match="plain"):
        jaxpickle.dumps({"inner": inner}, port_engine.JAX_NAMES, plain=(inner,))


def test_leave_one_out_map_equals_the_jax_packages(home, monkeypatch):
    home, _ = home
    monkeypatch.setenv("PIO_EVAL_APP_NAME", "URApp")
    js, ps = JaxStorage(JaxStorageConfig(home=home)), Storage(StorageConfig(home=home))
    jax_registry.set_storage(js)
    port_registry.set_storage(ps)
    try:
        _, jres = jax_run_evaluation(jax_engine.UREvaluation(),
                                     jax_engine.DefaultGrid().engine_params_list,
                                     storage=js, use_mesh=False)
        _, pres = run_evaluation(port_engine.UREvaluation(),
                                 port_engine.DefaultGrid().engine_params_list,
                                 storage=ps, device="cpu")
    finally:
        jax_registry.set_storage(None)
        port_registry.set_storage(None)
    assert port_engine.UREvaluation.metric.header == "MAP@10"
    assert [s for _, s, _ in pres.candidates] == [s for _, s, _ in jres.candidates]
    assert [o for _, _, o in pres.candidates] == [o for _, _, o in jres.candidates]
    assert pres.best_index == jres.best_index and pres.best_score > 0.1


def test_training_data_helpers_match():
    events = {"buy": [("a", "x"), ("b", "y"), ("a", "y")], "view": [("c", "z"), ("a", "x")]}
    j = jax_engine.TrainingData.from_events("app", events)
    p = port_engine.TrainingData.from_events("app", events)
    assert p.events == j.events == events
    keep = np.array([True, False, True])
    js, ps = j.subset_primary("buy", keep), p.subset_primary("buy", keep)
    assert ps.user_ids.to_dict() == js.user_ids.to_dict()
    assert ps.item_ids.to_dict() == js.item_ids.to_dict()
    for n in events:
        for a, b in zip(ps.pairs[n], js.pairs[n]):
            np.testing.assert_array_equal(a, b)
    algo = port_engine.URAlgorithm(port_engine.URAlgorithmParams())
    with pytest.raises(ValueError, match="primary"):
        algo.sanity_check(port_engine.TrainingData.from_events("a", {"buy": [], "view": [("u", "i")]}))
