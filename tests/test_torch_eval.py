"""``pio eval`` in the port held against the JAX package's, on the CPU.

Rate events made from a numpy seed (a planted rank-3 structure, 40 users
× 25 items) are written through each package's own storage into twin
temporary homes (SQLite meta and events). On them:

- ``RecDataSource.read_eval`` gives the JAX package's folds: the same
  seeded fold draw, trimmed vocabularies, query dicts and actuals;
  ``data/pipeline.subset_columnar`` is bitwise the JAX package's;
- ``run_evaluation(device="cpu")``, serial (``MetricEvaluator`` over
  ``Engine.eval_batch`` and ``train_many``) and distributed
  (``core/sweep.run_sweep`` over ``sweep_programs``), scores every
  candidate within 1e-4 relative of the JAX ``run_evaluation``
  (``use_mesh=False``) on the same grid, with the same best index, the
  same result JSON and the same leaderboard digest on all four runs;
- the sweep builds each program once per geometry bucket, pads an uneven
  grid with copies of row 0 and slices them off, ranks a candidate with
  no warm pair last as NaN, and falls back to the serial path for a
  group it cannot stack, as the JAX sweep does;
- ``FastEvalCache`` counts what the JAX package's counts;
- evaluation instance rows and ``leaderboard.json`` files written by
  either package are read by the other; a failing evaluation records
  FAILED with the exception's text;
- ``train_many`` and ``sweep_programs`` raise on a context with no device
  when there is no card: the eval path never carries on on the CPU
  unasked.

Data crosses between the packages as numpy arrays, SQLite rows and JSON.
"""

import datetime as dt
import json
import math
import os
import sqlite3
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import predictionio_tpu.models.als as jax_als
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.controller.base import WorkflowContext as JaxWorkflowContext
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.controller.engine import FastEvalCache as JaxFastEvalCache
from predictionio_tpu.core.sweep import run_sweep as jax_run_sweep
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.pipeline import subset_columnar as jax_subset_columnar
from predictionio_tpu.storage import leaderboard as jax_lb
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu.utils.bimap import BiMap as JaxBiMap
from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineParams,
    Evaluation,
    FastEvalCache,
    FirstServing,
    IdentityPreparator,
    Metric,
    WorkflowContext,
)
from predictionio_tpu_torch.core import sweep
from predictionio_tpu_torch.core.sweep import SweepProgram, run_sweep
from predictionio_tpu_torch.core.workflow import run_evaluation
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.pipeline import subset_columnar
from predictionio_tpu_torch.storage import leaderboard as lb
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates.recommendation import engine as port_rec
from predictionio_tpu_torch.utils.bimap import BiMap
from tests.test_sweep import ToyEvaluation as JaxToyEvaluation
from tests.test_sweep import _toy_candidates as jax_toy_candidates
from tests.test_sweep import toy_factory as jax_toy_factory

RTOL = 1e-4
APP, COLD_APP = "EvalApp", "ColdApp"
T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)


def _events():
    """(user, item, rating) rate events with a planted rank-3 structure,
    then one implicit buy; and a cold app where every user rates one
    item, so a held-out pair is never warm."""
    rng = np.random.default_rng(6)
    Ut, Vt = rng.normal(size=(40, 3)), rng.normal(size=(25, 3))
    rates = [(f"u{u}", f"i{i}", float(np.clip(Ut[u] @ Vt[i] + 3.0, 1, 5)))
             for u in range(40) for i in range(25) if rng.random() < 0.5]
    cold = [(f"c{j}", f"i{j}", 4.0) for j in range(12)]
    return rates, cold


def _seed(storage, event_cls):
    rates, cold = _events()
    for name, rows, buy in ((APP, rates, True), (COLD_APP, cold, False)):
        app = storage.meta.create_app(name)
        storage.events.init_channel(app.id)
        evs = [event_cls(event="rate", entity_type="user", entity_id=u,
                         target_entity_type="item", target_entity_id=i,
                         properties={"rating": r},
                         event_time=T0 + dt.timedelta(seconds=j))
               for j, (u, i, r) in enumerate(rows)]
        if buy:
            evs.append(event_cls(event="buy", entity_type="user", entity_id="u0",
                                 target_entity_type="item", target_entity_id="i1",
                                 event_time=T0 + dt.timedelta(seconds=len(rows))))
        storage.events.insert_batch(evs, app.id)


def _jax_storage(home):
    return JaxStorage(JaxStorageConfig(home=home))


def _port_storage(home):
    return Storage(StorageConfig(home=home))


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    homes = {name: str(tmp_path_factory.mktemp(f"pio_home_{name}"))
             for name in ("jax", "port")}
    _seed(_jax_storage(homes["jax"]), JaxEvent)
    _seed(_port_storage(homes["port"]), Event)
    return homes


def _cands(mod, engine_params, grid, iterations=4, eval_k=2):
    """One candidate per (app, rank, lambda) of ``grid``."""
    return [engine_params(
        data_source_params=mod.DataSourceParams(app_name=app, eval_k=eval_k),
        algorithms_params=[("als", mod.ALSAlgorithmParams(
            rank=r, num_iterations=iterations, lambda_=lam, seed=3))])
        for app, r, lam in grid]


GRID = [(APP, 4, 0.01), (APP, 4, 0.1), (APP, 8, 0.01), (APP, 8, 0.1)]
# a candidate on the cold app (no warm pair) between two warm ones
COLD_GRID = [(APP, 4, 0.05), (COLD_APP, 4, 0.05), (APP, 4, 0.2)]


def _jax_eval(home, grid, distributed):
    iid, res = jax_run_evaluation(
        jax_rec.RecEvaluation(), _cands(jax_rec, JaxEngineParams, grid),
        storage=_jax_storage(home), use_mesh=False, distributed=distributed)
    return iid, res, jax_lb.read(home, iid)


def _port_eval(home, grid, distributed):
    iid, res = run_evaluation(
        port_rec.RecEvaluation(), _cands(port_rec, EngineParams, grid),
        storage=_port_storage(home), distributed=distributed, device="cpu")
    return iid, res, lb.read(home, iid)


@pytest.fixture(scope="module")
def runs(homes):
    """GRID evaluated serially and distributed by both packages."""
    return {(name, dist): run(homes[name], GRID, dist)
            for name, run in (("jax", _jax_eval), ("port", _port_eval))
            for dist in (False, True)}


def _scores(res):
    return [s for _, s, _ in res.candidates]


# -- the folds -----------------------------------------------------------------


def test_read_eval_folds_equal_the_jax_packages(homes):
    p = dict(app_name=APP, eval_k=3, eval_seed=11)
    theirs = jax_rec.RecDataSource(jax_rec.DataSourceParams(**p)).read_eval(
        JaxWorkflowContext(storage=_jax_storage(homes["jax"])))
    mine = port_rec.RecDataSource(port_rec.DataSourceParams(**p)).read_eval(
        WorkflowContext(storage=_port_storage(homes["port"]), device="cpu"))
    assert len(mine) == len(theirs) == 3
    for (td, info, qa), (ttd, tinfo, tqa) in zip(mine, theirs):
        for name in ("user_idx", "item_idx", "rating"):
            a, b = getattr(td, name), getattr(ttd, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert td.user_ids.to_dict() == ttd.user_ids.to_dict()
        assert td.item_ids.to_dict() == ttd.item_ids.to_dict()
        # trimmed: a fold knows only the entities of its training rows
        assert len(td.user_ids) == len(np.unique(td.user_idx))
        assert info == tinfo and qa == tqa and qa


def test_subset_columnar_is_bitwise_the_jax_packages():
    rng = np.random.default_rng(2)
    uu = rng.integers(0, 30, 200).astype(np.int32)
    ii = rng.integers(0, 17, 200).astype(np.int32)
    rr = rng.uniform(1, 5, 200).astype(np.float32)
    extra = rng.integers(0, 9, 200)
    users = {f"u{j}": j for j in range(30)}
    items = {f"i{j}": j for j in range(17)}
    mask = rng.random(200) < 0.3
    mine = subset_columnar(mask, uu, ii, BiMap(users), BiMap(items), rr, extra)
    theirs = jax_subset_columnar(mask, uu, ii, JaxBiMap(users), JaxBiMap(items),
                                 rr, extra)
    assert len(mine) == len(theirs) == 6
    for j in (0, 1, 4, 5):
        assert mine[j].dtype == theirs[j].dtype
        assert np.array_equal(mine[j], theirs[j])
    for j in (2, 3):
        assert mine[j].to_dict() == theirs[j].to_dict()
    assert len(mine[2]) < 30 and len(mine[3]) < 17  # some entities cold


# -- serial and distributed against the JAX package ---------------------------


def test_serial_scores_match_the_jax_package(runs):
    _, mine, _ = runs["port", False]
    _, theirs, _ = runs["jax", False]
    np.testing.assert_allclose(_scores(mine), _scores(theirs), rtol=RTOL)
    assert mine.best_index == theirs.best_index
    doc, ref = json.loads(mine.to_json()), json.loads(theirs.to_json())
    for d in (doc, ref):
        d.pop("bestScore")
        for c in d["candidates"]:
            c.pop("score")
    assert doc == ref


def test_distributed_scores_and_digests_match_the_jax_package(runs):
    _, mine, doc = runs["port", True]
    _, theirs, ref = runs["jax", True]
    np.testing.assert_allclose(_scores(mine), _scores(theirs), rtol=RTOL)
    # the port's two paths train the same candidates through the same ops
    np.testing.assert_allclose(_scores(mine), _scores(runs["port", False][1]),
                               rtol=1e-5)
    by_index = {e["index"]: e for e in ref["entries"]}
    for e in doc["entries"]:
        np.testing.assert_allclose(e["foldScores"],
                                   by_index[e["index"]]["foldScores"], rtol=RTOL)
    digests = {key: lb.digest(d) for key, (_, _, d) in runs.items()}
    assert len(set(digests.values())) == 1, digests
    assert jax_lb.digest(doc) == lb.digest(ref)
    for key in ("buckets", "compiles", "dispatches", "vmapped", "serial", "shards"):
        assert doc[key] == ref[key], key
    assert doc["compiles"] <= doc["buckets"] == 4  # two ranks in two folds
    assert doc["mode"] == "distributed" and runs["port", False][2]["mode"] == "serial"


def test_uneven_grid_pads_rows_and_slices_them_off(homes):
    st = _port_storage(homes["port"])
    grid = [(APP, 4, 0.01), (APP, 4, 0.05), (APP, 4, 0.1)]
    ctx = WorkflowContext(storage=st, device="cpu")
    sres = run_sweep(ctx, port_rec.engine_factory(),
                     _cands(port_rec, EngineParams, grid), port_rec.NegRMSE())
    assert sres.vmapped == 3 and sres.serial == 0
    assert sres.compiles <= sres.buckets == 2 and sres.dispatches == 2
    assert len(sres.result.candidates) == 3
    assert all(len(f) == 2 for f in sres.fold_scores)
    serial = port_rec.RecEvaluation().run(ctx, _cands(port_rec, EngineParams, grid))
    np.testing.assert_allclose(_scores(sres.result), _scores(serial), rtol=1e-5)

    # the program runs the padded width: the pad row repeats row 0
    seen = []

    def build():
        def one(row, x):
            seen.append(row.copy())
            return float(row[0] * x), 1.0
        return one

    hyper = np.asarray([[1.0], [2.0], [3.0]], np.float32)
    sums, counts, _ = sweep._dispatch(
        SweepProgram(("toy",), build, hyper, (2.0,), [0, 1, 2]),
        sweep._SweepCache(), 0)
    assert sweep.GRID_LADDER.snap(3) == 4
    assert [float(r[0]) for r in seen] == [1.0, 2.0, 3.0, 1.0]
    assert sums.tolist() == [2.0, 4.0, 6.0] and counts.tolist() == [1.0] * 3


def test_a_candidate_with_no_warm_pair_is_nan_and_ranks_last(homes):
    docs = []
    for name, run in (("jax", _jax_eval), ("port", _port_eval)):
        for dist in (False, True):
            _, res, doc = run(homes[name], COLD_GRID, dist)
            assert math.isnan(res.candidates[1][1]), (name, dist)
            assert res.best_index in (0, 2)
            entry = {e["index"]: e for e in doc["entries"]}[1]
            assert entry["rank"] == 2 and entry["score"] is None
            docs.append(doc)
    assert len({lb.digest(d) for d in docs}) == 1

    # the device program itself: no valid pair → count 0 → NaN
    prep = port_als.als_prepare(port_als.RatingsCOO(
        np.asarray([0, 1, 1], np.int32), np.asarray([0, 0, 1], np.int32),
        np.asarray([3.0, 4.0, 5.0], np.float32), 2, 2))
    p = port_als.ALSParams(rank=2, iterations=2)
    _, build, data = port_als.als_sweep_program(
        prep, p, np.zeros(3, np.int32), np.zeros(3, np.int32),
        np.ones(3, np.float32), np.zeros(3, bool), device="cpu")
    s, c = build()(np.asarray([0.01, 1.0], np.float32), *data)
    assert float(s) == 0.0 and float(c) == 0.0
    assert math.isnan(port_rec.NegRMSE().sweep_finalize(float(s), float(c)))


# -- a toy engine: the sweep's grouping and fallback --------------------------


@dataclass
class ToyDSParams:
    n: int = 40
    eval_k: int = 2


@dataclass
class ToyData:
    x: np.ndarray
    y: np.ndarray


class ToyDS(DataSource):
    """The JAX package's toy data source of tests/test_sweep.py: y = 3x."""

    ParamsClass = ToyDSParams

    def _all(self):
        rng = np.random.default_rng(7)
        x = rng.normal(1.0, 0.5, self.params.n).astype(np.float32)
        return x, (3.0 * x).astype(np.float32)

    def read_training(self, ctx):
        return ToyData(*self._all())

    def read_eval(self, ctx):
        x, y = self._all()
        k = self.params.eval_k
        folds = []
        for f in range(k):
            tr = np.arange(len(x)) % k != f
            qa = [({"x": float(x[j])}, float(y[j])) for j in np.nonzero(~tr)[0]]
            folds.append((ToyData(x[tr], y[tr]), {"fold": f}, qa))
        return folds


@dataclass
class ToyParams:
    scale: float = 1.0


class ToyAlgo(Algorithm):
    ParamsClass = ToyParams

    def train(self, ctx, pd):
        return {"scale": float(self.params.scale)}

    @classmethod
    def sweep_programs(cls, ctx, pd, params_list, qa, metric):
        if getattr(metric, "sweep_kind", None) != "sq_err":
            return None
        xe = torch.as_tensor([q["x"] for q, _ in qa], dtype=torch.float32)
        ye = torch.as_tensor([a for _, a in qa], dtype=torch.float32)

        def build():
            def one(hyper, xe, ye):
                err = float(hyper[0]) * xe - ye
                return (err * err).sum(), torch.tensor(float(xe.shape[0]))
            return one

        hyper = np.asarray([[p.scale] for p in params_list], np.float32)
        return [SweepProgram(("toy", tuple(xe.shape)), build, hyper,
                             (xe, ye), list(range(len(params_list))))]

    def predict(self, model, query):
        return {"y": model["scale"] * query["x"]}


class PlainAlgo(ToyAlgo):
    """No sweep program: its whole group takes the serial path."""

    @classmethod
    def sweep_programs(cls, ctx, pd, params_list, qa, metric):
        return None


class ToyNegRMSE(Metric):
    sweep_kind = "sq_err"

    def calculate(self, ctx, eval_data):
        errs = [(p["y"] - a) ** 2 for _, qpa in eval_data for q, p, a in qpa]
        return -math.sqrt(sum(errs) / len(errs)) if errs else float("nan")

    def sweep_finalize(self, stat_sum, stat_count):
        if stat_count <= 0:
            return float("nan")
        return -math.sqrt(stat_sum / stat_count)

    @property
    def header(self):
        return "ToyNegRMSE"


def toy_factory():
    return Engine(data_source_cls=ToyDS, preparator_cls=IdentityPreparator,
                  algorithm_cls_map={"toy": ToyAlgo, "plain": PlainAlgo},
                  serving_cls=FirstServing)


class ToyEvaluation(Evaluation):
    engine_factory = staticmethod(toy_factory)
    metric = ToyNegRMSE()


def _toy_candidates(scales, algo="toy"):
    return [EngineParams(ToyDSParams(), None, [(algo, ToyParams(scale=s))], None)
            for s in scales]


def test_mixed_grid_falls_back_to_serial_for_the_ineligible_group(tmp_path):
    st = Storage(StorageConfig(home=str(tmp_path)))
    scales = [1.0, 3.0]
    mine = run_sweep(WorkflowContext(storage=st, device="cpu"), toy_factory(),
                     _toy_candidates(scales) + _toy_candidates(scales, "plain"),
                     ToyNegRMSE())
    theirs = jax_run_sweep(
        JaxWorkflowContext(storage=_jax_storage(str(tmp_path))), jax_toy_factory(),
        jax_toy_candidates(scales) + jax_toy_candidates(scales, "plain"),
        JaxToyEvaluation.metric)
    assert (mine.vmapped, mine.serial) == (theirs.vmapped, theirs.serial) == (2, 2)
    # y = 3x exactly in f32: the scale-3 candidates score 0 up to rounding
    np.testing.assert_allclose(_scores(mine.result), _scores(theirs.result),
                               rtol=1e-6, atol=1e-6)
    assert mine.result.best_index == theirs.result.best_index == 1
    # NaN hyperparameters: that candidate ranks last on both of the port's paths
    for dist in (False, True):
        iid, res = run_evaluation(ToyEvaluation(), _toy_candidates([3.0, float("nan"), 1.0]),
                                  storage=st, distributed=dist, device="cpu")
        assert res.best_index == 0 and math.isnan(res.candidates[1][1])
        assert {e["index"]: e["rank"] for e in lb.read(str(tmp_path), iid)["entries"]}[1] == 2


def test_sweep_shards_warn_and_run_unsharded(tmp_path):
    """No device mesh in the port yet: the JAX package's warning for a
    pool too small, then the unsharded sweep with the same scores."""
    ctx = WorkflowContext(storage=Storage(StorageConfig(home=str(tmp_path))),
                          device="cpu")
    base = run_sweep(ctx, toy_factory(), _toy_candidates([0.5, 2.0]), ToyNegRMSE())
    with pytest.warns(RuntimeWarning, match="sweep_shards=4 unavailable"):
        sharded = run_sweep(ctx, toy_factory(), _toy_candidates([0.5, 2.0]),
                            ToyNegRMSE(), sweep_shards=4)
    assert base.shards == sharded.shards == 0
    assert _scores(sharded.result) == _scores(base.result)


def test_fast_eval_cache_stats_equal_the_jax_packages(homes):
    grid = [(APP, 4, 0.01), (APP, 4, 0.1)]
    stats = {}
    for name, mod, ep_cls, cache, ctx in (
            ("jax", jax_rec, JaxEngineParams, JaxFastEvalCache(),
             JaxWorkflowContext(storage=_jax_storage(homes["jax"]))),
            ("port", port_rec, EngineParams, FastEvalCache(),
             WorkflowContext(storage=_port_storage(homes["port"]), device="cpu"))):
        cands = (_cands(mod, ep_cls, grid, iterations=2)
                 + _cands(mod, ep_cls, grid[:1], iterations=2, eval_k=3))
        engine = mod.engine_factory()
        out = engine.eval_batch(ctx, cands, cache)
        engine.eval_batch(ctx, cands[:1], cache)
        assert [len(ed) for ed in out] == [2, 2, 3]
        stats[name] = cache.stats
    assert stats["port"] == stats["jax"] == {
        "read_eval": 2, "read_eval_hits": 1, "prepare": 5, "prepare_hits": 2}


# -- storage across packages ---------------------------------------------------


def test_instances_and_leaderboards_are_read_across_packages(homes, runs):
    for name, other, reader, lb_mod in (
            ("jax", "port", _port_storage, lb), ("port", "jax", _jax_storage, jax_lb)):
        own = (_jax_storage if name == "jax" else _port_storage)(homes[name])
        for dist in (False, True):
            iid, _, doc = runs[name, dist]
            got = reader(homes[name]).meta.get_evaluation_instance(iid)
            ref = own.meta.get_evaluation_instance(iid)
            assert got is not None and got.status == "EVALCOMPLETED"
            for f in ("id", "status", "start_time", "end_time", "evaluation_class",
                      "engine_params_generator_class", "batch", "env",
                      "evaluator_results", "evaluator_results_html",
                      "evaluator_results_json"):
                assert getattr(got, f) == getattr(ref, f), f
            assert lb_mod.read(homes[name], iid) == doc
        listed = [vi.id for vi in reader(homes[name]).meta.list_evaluation_instances()]
        assert {runs[name, d][0] for d in (False, True)} <= set(listed)

    def columns(home):
        with sqlite3.connect(os.path.join(home, "meta.db")) as c:
            return c.execute("PRAGMA table_info(evaluation_instances)").fetchall()

    assert columns(homes["port"]) == columns(homes["jax"])


class BoomDS(ToyDS):
    def read_eval(self, ctx):
        raise ValueError("boom: no such app")


class BoomEvaluation(Evaluation):
    engine_factory = staticmethod(lambda: Engine(
        data_source_cls=BoomDS, preparator_cls=IdentityPreparator,
        algorithm_cls_map={"toy": ToyAlgo}, serving_cls=FirstServing))
    metric = ToyNegRMSE()


@pytest.mark.parametrize("distributed", [False, True])
def test_a_failing_evaluation_records_failed_with_the_exception(tmp_path, distributed):
    st = Storage(StorageConfig(home=str(tmp_path)))
    with pytest.raises(ValueError, match="boom"):
        run_evaluation(BoomEvaluation(), _toy_candidates([1.0]), storage=st,
                       distributed=distributed, device="cpu")
    [vi] = st.meta.list_evaluation_instances()
    assert vi.status == "FAILED" and vi.end_time is not None
    assert vi.evaluator_results == "ValueError: boom: no such app"
    assert lb.latest(str(tmp_path)) is None


# -- the device ---------------------------------------------------------------


def test_eval_needs_a_card_or_a_cpu_request(homes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = _port_storage(homes["port"])
    ctx = WorkflowContext(storage=st)  # no device: CUDA, and there is none
    [(td, _, qa)] = port_rec.RecDataSource(
        port_rec.DataSourceParams(app_name=APP, eval_k=1)).read_eval(ctx)[:1]
    params = [port_rec.ALSAlgorithmParams(rank=2, num_iterations=1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rec.ALSAlgorithm.train_many(ctx, td, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_rec.ALSAlgorithm.sweep_programs(ctx, td, params, qa, port_rec.NegRMSE())
    before = len(st.meta.list_evaluation_instances())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_evaluation(port_rec.RecEvaluation(), _cands(port_rec, EngineParams, GRID[:1]),
                       storage=st, distributed=True)
    assert len(st.meta.list_evaluation_instances()) == before


# -- the ALS programs ---------------------------------------------------------


def _ratings(seed=4, n_u=30, n_i=20, nnz=240):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_u * n_i, nnz))
    return (np.asarray(key // n_i, np.int32), np.asarray(key % n_i, np.int32),
            rng.uniform(1, 5, len(key)).astype(np.float32), n_u, n_i)


def test_als_train_many_trains_each_candidate_as_train_does():
    data = _ratings()
    params = [port_als.ALSParams(rank=4, iterations=3, reg=lam, seed=2)
              for lam in (0.01, 0.3)]
    mine = port_als.als_train_many(port_als.RatingsCOO(*data), params, device="cpu")
    theirs = jax_als.als_train_many(jax_als.RatingsCOO(*data),
                                    [jax_als.ALSParams(**vars(p)) for p in params])
    prep = port_als.als_prepare(port_als.RatingsCOO(*data))
    for p, (U, V), (tU, tV) in zip(params, mine, theirs):
        U1, V1 = port_als.als_train_prepared(prep, p, device="cpu")
        assert np.array_equal(U, U1) and np.array_equal(V, V1)
        np.testing.assert_allclose(U, tU, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(V, tV, rtol=RTOL, atol=RTOL)


def test_als_sweep_program_scores_the_fold_as_its_factors_do():
    uu, ii, rr, n_u, n_i = _ratings(seed=5)
    prep = port_als.als_prepare(port_als.RatingsCOO(uu, ii, rr, n_u, n_i))
    rng = np.random.default_rng(8)
    users = rng.integers(0, n_u, 50).astype(np.int32)
    items = rng.integers(0, n_i, 50).astype(np.int32)
    held = rng.uniform(1, 5, 50).astype(np.float32)
    valid = rng.random(50) < 0.8
    p0 = port_als.ALSParams(rank=4, iterations=3, seed=1)
    _, build, data = port_als.als_sweep_program(prep, p0, users, items, held,
                                                valid, device="cpu")
    one = build()
    for reg, alpha in ((0.01, 1.0), (0.1, 1.0)):
        row = np.asarray([reg, alpha], np.float32)
        s, c = one(row, *data)
        U, V = port_als.als_train_prepared(
            prep, port_als.ALSParams(rank=4, iterations=3, seed=1,
                                     reg=float(row[0])), device="cpu")
        pred = np.einsum("nk,nk->n", U[users].astype(np.float64),
                         V[items].astype(np.float64))
        err = ((pred - held) ** 2)[valid].sum()
        assert float(c) == valid.sum()
        np.testing.assert_allclose(float(s), err, rtol=1e-5)
