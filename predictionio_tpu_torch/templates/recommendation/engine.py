"""Recommendation template: ALS collaborative filtering on the card.

Behavioral equivalent of the JAX package's template of the same path
(reference: [U] examples/scala-parallel-recommendation/, SURVEY.md §2c):
the data source reads "rate"/"buy" events into columnar ratings, the
algorithm trains explicit (or implicit) ALS through the ``gather_gram``
and ``chol_solve`` kernels, serving is first. The query/response wire
shapes are the reference's:

    POST /queries.json  {"user": "1", "num": 4}
    → {"itemScores": [{"item": "22", "score": 4.5}, ...]}

and the model blob is the JAX package's (a pickle holding an npz of U and
V and the two id maps), so an instance trained by either package deploys
in the other.

``pio eval`` runs out of the box: ``read_eval`` draws the JAX package's
folds (the same seeded draw, the same trimmed vocabularies and query
dicts), ``NegRMSE`` scores held-out ratings, ``RecEvaluation`` binds the
two and ``DefaultGrid`` is the JAX package's grid. The serial path trains
each fold's candidates through ``train_many`` over one uploaded layout
and answers the rating queries on the host; the distributed path
(``sweep_programs``) trains and scores every candidate on the device.
"""

from __future__ import annotations

import io
import math
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    Metric,
    Preparator,
    WorkflowContext,
)
from predictionio_tpu_torch.data.cleaning import SelfCleaningDataSource
from predictionio_tpu_torch.models.als import (
    ALSParams,
    RatingsCOO,
    als_train,
    recommend,
)
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclass
class Rating:
    user: str
    item: str
    rating: float


@dataclass
class TrainingData:
    """Columnar, index-mapped interactions + id vocabularies, built by the
    streaming read (``data/pipeline.read_interactions``): 12 B per event
    instead of a list of Rating objects. ``ratings`` materializes Rating
    objects lazily for small-data consumers (tests, debugging)."""

    user_idx: np.ndarray   # int32 [n]
    item_idx: np.ndarray   # int32 [n]
    rating: np.ndarray     # float32 [n]
    user_ids: BiMap
    item_ids: BiMap

    @property
    def n(self) -> int:
        return int(self.user_idx.shape[0])

    @property
    def ratings(self) -> List[Rating]:
        u_inv = self.user_ids.inverse()
        i_inv = self.item_ids.inverse()
        return [Rating(u_inv[int(u)], i_inv[int(i)], float(r))
                for u, i, r in zip(self.user_idx, self.item_idx,
                                   self.rating)]

    @classmethod
    def from_ratings(cls, ratings: List[Rating]) -> "TrainingData":
        user_ids = BiMap.string_int(r.user for r in ratings)
        item_ids = BiMap.string_int(r.item for r in ratings)
        return cls(
            np.fromiter((user_ids[r.user] for r in ratings), np.int32,
                        len(ratings)),
            np.fromiter((item_ids[r.item] for r in ratings), np.int32,
                        len(ratings)),
            np.fromiter((r.rating for r in ratings), np.float32,
                        len(ratings)),
            user_ids, item_ids)

    def subset(self, mask: np.ndarray) -> "TrainingData":
        """Rows where ``mask`` holds, vocabularies trimmed (eval-fold
        cold-entity rule — see ``data/pipeline.subset_columnar``)."""
        from predictionio_tpu_torch.data.pipeline import subset_columnar

        uu, ii, u_ids, i_ids, rr = subset_columnar(
            mask, self.user_idx, self.item_idx,
            self.user_ids, self.item_ids, self.rating)
        return TrainingData(uu, ii, rr, u_ids, i_ids)


@dataclass
class DataSourceParams:
    app_name: str = ""
    event_names: List[str] = field(default_factory=lambda: ["rate", "buy"])
    # rating assigned to implicit "buy" events (reference quickstart: 4.0)
    buy_rating: float = 4.0
    eval_k: int = 0          # >0 enables read_eval with k folds
    eval_seed: int = 3
    #: optional {"duration": "30 days", "removeDuplicates": bool,
    #: "compressProperties": bool} — SelfCleaningDataSource window
    event_window: Optional[Dict[str, Any]] = None


class RecDataSource(SelfCleaningDataSource, DataSource):
    ParamsClass = DataSourceParams

    def _read(self, ctx: WorkflowContext) -> TrainingData:
        """Stream the event store into columnar TrainingData in two passes
        (``data/store.read_training_interactions``). "rate" events carry
        ``properties["rating"]`` (malformed → event skipped); any other
        configured event is an implicit positive at ``buy_rating``."""
        from predictionio_tpu_torch.data.store import read_training_interactions

        p: DataSourceParams = self.params
        data = read_training_interactions(
            p.app_name,
            entity_type="user",
            target_entity_type="item",
            event_names=p.event_names,
            value_key="rating",
            value_spec={"rate": "prop"},
            default_spec=p.buy_rating,
            storage=ctx.storage,
        )
        uu, ii, rr = data.arrays()
        return TrainingData(uu, ii, rr, data.user_ids, data.item_ids)

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        self.clean(ctx, self.params.app_name)
        td = self._read(ctx)
        if td.n == 0:
            raise ValueError(
                "no rate/buy events found; import events before `pio train`")
        return td

    def read_eval(self, ctx: WorkflowContext):
        """``eval_k`` folds: each rating's fold is drawn with
        ``eval_seed``; a fold trains on the other folds' ratings (the
        vocabularies trimmed to them) and is queried with its own as
        ``{"user", "item", "num": 1}`` rating queries."""
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            raise ValueError("set dataSourceParams.evalK > 0 to evaluate")
        td = self._read(ctx)
        rng = np.random.default_rng(p.eval_seed)
        fold_of = rng.integers(0, p.eval_k, size=td.n)
        u_inv = td.user_ids.inverse()
        i_inv = td.item_ids.inverse()
        folds = []
        for f in range(p.eval_k):
            train = td.subset(fold_of != f)
            test = np.nonzero(fold_of == f)[0]
            qa = [({"user": u_inv[int(td.user_idx[j])],
                    "item": i_inv[int(td.item_idx[j])], "num": 1},
                   float(td.rating[j])) for j in test]
            folds.append((train, {"fold": f}, qa))
        return folds


class RecPreparator(Preparator):
    """Pass-through (reference quickstart Preparator)."""

    def prepare(self, ctx: WorkflowContext, training_data: TrainingData) -> TrainingData:
        return training_data


@dataclass
class ALSAlgorithmParams:
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: Optional[int] = None
    implicit_prefs: bool = False
    alpha: float = 1.0
    # mid-train checkpoint cadence (`pio train --resume`): save every N
    # iterations under the workflow's checkpoint dir (0 = off)
    checkpoint_every: int = 5
    # bf16 factor gathers (see models/als.py ALSParams.bf16_gather)
    bf16_gather: bool = False


class ALSModel:
    """Resident serving model: factor matrices + id↔index BiMaps.

    Serving is device-resident for production-size catalogs: the first
    query builds a lazy :class:`~predictionio_tpu_torch.models.als.ResidentScorer`
    on ``device`` (U and V stay in device memory; each batch is one
    gather → score → top-k kernel launch). Tiny catalogs score host-side
    instead; the policy and its ``PIO_ALS_SERVE`` override live in
    ``models/als.maybe_resident_scorer``.
    """

    def __init__(self, U: np.ndarray, V: np.ndarray,
                 user_ids: BiMap, item_ids: BiMap, device=None) -> None:
        self.U = U
        self.V = V
        self.user_ids = user_ids
        self.item_ids = item_ids
        self.device = device
        self._item_inv = item_ids.inverse()
        self._scorer = None

    def _device_scorer(self):
        from predictionio_tpu_torch.models.als import maybe_resident_scorer

        self._scorer = maybe_resident_scorer(self.U, self.V, self._scorer,
                                             device=self.device)
        return self._scorer

    def recommend_products(self, user: str, num: int) -> List[Dict[str, Any]]:
        uidx = self.user_ids.get(user)
        if uidx is None:
            return []
        scorer = self._device_scorer()
        if scorer is not None:
            top, scores = scorer.recommend(uidx, num)
        else:
            top, scores = recommend(self.U, self.V, uidx, num)
        return [
            {"item": self._item_inv[int(i)], "score": float(s)}
            for i, s in zip(top, scores)
        ]

    def predict_rating(self, user: str, item: str) -> Optional[float]:
        uidx = self.user_ids.get(user)
        iidx = self.item_ids.get(item)
        if uidx is None or iidx is None:
            return None
        return float(self.U[uidx] @ self.V[iidx])


class ALSAlgorithm(Algorithm):
    ParamsClass = ALSAlgorithmParams

    def sanity_check(self, data: TrainingData) -> None:
        if data.n == 0:
            raise ValueError("empty TrainingData")

    @staticmethod
    def _to_coo(pd: TrainingData):
        # the streaming read already index-mapped everything: this is a
        # zero-copy repackaging, not a conversion
        coo = RatingsCOO(
            user_idx=pd.user_idx,
            item_idx=pd.item_idx,
            rating=pd.rating,
            n_users=len(pd.user_ids),
            n_items=len(pd.item_ids),
        )
        return coo, pd.user_ids, pd.item_ids

    @staticmethod
    def _als_params(p: ALSAlgorithmParams) -> ALSParams:
        return ALSParams(
            rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
            implicit=p.implicit_prefs, alpha=p.alpha,
            seed=0 if p.seed is None else p.seed,
            bf16_gather=p.bf16_gather,
        )

    @classmethod
    def train_many(cls, ctx: WorkflowContext, pd: TrainingData,
                   params_list) -> List[ALSModel]:
        """Grid fan-out (``pio eval``) on ``ctx.device``: the layout is
        built and uploaded once, then each candidate trains over it
        (``models/als.als_train_many``)."""
        from predictionio_tpu_torch.models.als import als_train_many

        coo, user_ids, item_ids = cls._to_coo(pd)
        results = als_train_many(
            coo, [cls._als_params(p) for p in params_list], device=ctx.device)
        return [ALSModel(U, V, user_ids, item_ids, device=ctx.device)
                for U, V in results]

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> ALSModel:
        """Train on ``self.device`` (set by Engine.train from the
        workflow context; CUDA unless the run asked for the CPU)."""
        coo, user_ids, item_ids = self._to_coo(pd)
        U, V = als_train(
            coo, self._als_params(self.params), device=self.device,
            # restart-from-checkpoint (run_train --resume): save U and V
            # every checkpoint_every iterations under the workflow's dir
            checkpointer=ctx.checkpointer("als"),
            checkpoint_every=self.params.checkpoint_every)
        return ALSModel(U, V, user_ids, item_ids, device=self.device)

    def predict(self, model: ALSModel, query: Dict[str, Any]) -> Dict[str, Any]:
        user = str(query["user"])
        if "item" in query:  # rating-prediction shape (used by evaluation)
            r = model.predict_rating(user, str(query["item"]))
            return {"itemScores": (
                [{"item": str(query["item"]), "score": r}] if r is not None else [])}
        num = int(query.get("num", 10))
        return {"itemScores": model.recommend_products(user, num)}

    #: serve_topk_batch skips AOT-bucket PAD sentinels inline (their
    #: slots come back None), so the deploy layer can hand us the
    #: padded batch directly
    accepts_padding = True

    def batch_predict(self, model: ALSModel, queries) -> List[Dict[str, Any]]:
        """Micro-batched serving: all top-k-shaped queries in the batch
        score in ONE device dispatch via ``models/als.serve_topk_batch``.
        Rating-prediction shapes and cold users are answered per query."""
        from predictionio_tpu_torch.models.als import serve_topk_batch

        return serve_topk_batch(
            model._device_scorer(), model.user_ids, model._item_inv,
            queries, fallback=lambda q: self.predict(model, q),
            per_query=lambda q: "item" in q)

    @classmethod
    def sweep_programs(cls, ctx: WorkflowContext, pd: TrainingData,
                       params_list, qa, metric):
        """Distributed ``pio eval`` (core/sweep.py) on ``ctx.device``:
        candidates sharing (rank, iterations, implicit, seed, bf16) bucket
        into ONE train+score program over stacked [lambda, alpha] float32
        rows. Held-out pairs are mapped to the fold's dense ids here; cold
        pairs (user/item unseen by the trained fold) get valid=False,
        mirroring NegRMSE's skip-empty-prediction convention."""
        if getattr(metric, "sweep_kind", None) != "sq_err":
            return None
        from predictionio_tpu_torch.core.sweep import SweepProgram
        from predictionio_tpu_torch.models.als import (als_prepare,
                                                       als_sweep_program)

        coo, user_ids, item_ids = cls._to_coo(pd)
        prep = als_prepare(coo)
        n = len(qa)
        users = np.zeros(n, np.int32)
        items = np.zeros(n, np.int32)
        ratings = np.zeros(n, np.float32)
        valid = np.zeros(n, bool)
        for j, (q, a) in enumerate(qa):
            uidx = user_ids.get(str(q.get("user")))
            iidx = (item_ids.get(str(q["item"])) if "item" in q else None)
            if uidx is not None and iidx is not None:
                users[j], items[j], valid[j] = uidx, iidx, True
            ratings[j] = float(a)
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(params_list):
            key = (int(p.rank), int(p.num_iterations),
                   bool(p.implicit_prefs),
                   0 if p.seed is None else int(p.seed),
                   bool(p.bf16_gather))
            groups.setdefault(key, []).append(i)
        progs = []
        for idxs in groups.values():
            p0 = cls._als_params(params_list[idxs[0]])
            geometry, build, data = als_sweep_program(
                prep, p0, users, items, ratings, valid, device=ctx.device)
            hyper = np.asarray(
                [[params_list[i].lambda_, params_list[i].alpha]
                 for i in idxs], np.float32)
            progs.append(SweepProgram(geometry, build, hyper, data, idxs))
        return progs

    def aot_warm(self, model: ALSModel, ladder, ks=(16,)):
        """Warm the gather → score → top-k program for every (bucket, k)
        before traffic arrives; host-path catalogs have nothing to warm."""
        scorer = model._device_scorer()
        if scorer is None:
            return {"targets": 0, "compiled": 0, "cached": 0}
        return scorer.warm_buckets(ladder, ks)

    # the JAX package's blob format: pickle of npz factors + id maps
    def save_model(self, model: ALSModel, instance_dir: Optional[str]) -> bytes:
        buf = io.BytesIO()
        np.savez_compressed(buf, U=model.U, V=model.V)
        return pickle.dumps({
            "npz": buf.getvalue(),
            "user_ids": model.user_ids.to_dict(),
            "item_ids": model.item_ids.to_dict(),
        })

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]) -> ALSModel:
        if blob is None:
            raise ValueError("ALSAlgorithm.load_model needs the model blob")
        d = pickle.loads(blob)
        arrs = np.load(io.BytesIO(d["npz"]))
        return ALSModel(arrs["U"], arrs["V"],
                        BiMap(d["user_ids"]), BiMap(d["item_ids"]),
                        device=self.device)


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=RecDataSource,
        preparator_cls=RecPreparator,
        algorithm_cls_map={"als": ALSAlgorithm},
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box) -------------------------------------


class NegRMSE(Metric):
    """-RMSE of predicted vs held-out ratings over the eval folds
    (higher is better, so the evaluator's argmax picks the lowest
    error). Cold (user, item) pairs — unknown to the trained fold —
    are skipped, the OptionAverageMetric convention."""

    higher_is_better = True
    #: distributed sweeps (core/sweep.py) accumulate (Σ sq_err, #warm)
    #: on the device; sweep_finalize folds them into the same -RMSE
    sweep_kind = "sq_err"

    def sweep_finalize(self, stat_sum: float, stat_count: float) -> float:
        return (-math.sqrt(stat_sum / stat_count) if stat_count > 0
                else float("nan"))

    def calculate(self, ctx, eval_data):
        errs = []
        for _, qpa in eval_data:
            for q, p, a in qpa:
                scores = p.get("itemScores", [])
                if scores and scores[0].get("score") is not None:
                    errs.append((float(scores[0]["score"]) - float(a)) ** 2)
        return (-math.sqrt(sum(errs) / len(errs)) if errs
                else float("nan"))

    @property
    def header(self) -> str:
        return "NegRMSE"


class RecEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = NegRMSE()


class DefaultGrid(EngineParamsGenerator):
    """Rank/λ candidates over 2 folds; app via $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        return [EngineParams(
            data_source_params=DataSourceParams(app_name=app, eval_k=2),
            algorithms_params=[("als", ALSAlgorithmParams(
                rank=r, num_iterations=8, lambda_=lam, seed=3))])
            for r in (8, 16) for lam in (0.01, 0.1)]
