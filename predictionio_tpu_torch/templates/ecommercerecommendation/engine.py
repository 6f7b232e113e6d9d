"""E-Commerce Recommendation template: implicit ALS + live business rules.

Behavioral equivalent of the JAX package's template of the same path
(reference: [U] examples/scala-parallel-ecommercerecommendation/ —
implicit ALS on view/buy events; at query time: exclude items the user
has seen (read LIVE from the event store), exclude globally unavailable
items (a ``constraint`` entity's ``$set`` events, read live so ops can
flip availability without retraining), category filter, white/black
lists, and a popularity fallback for unknown/cold-start users;
SURVEY.md §2c).

    POST /queries.json {"user": "u1", "num": 4, "categories": ["c1"],
                        "whiteList": [], "blackList": ["i3"]}
    → {"itemScores": [{"item": "i2", "score": 1.2}, ...]}

Training runs implicit ALS on the card; catalogs of at least 2,048 items
are scored from factors resident on the card (``score_topk``), smaller
ones on the host. The live lookups run on the host around the scoring.

The blob is the JAX package's: a pickled dict that holds the algorithm's
params dataclass, which the pickle names by the JAX package's module
path. The port reads it with an unpickler that maps that one name to
its own class (and refuses any other name of the JAX package), and
writes a pickle that names the JAX module path without importing it, so
either package loads what the other wrote and neither imports the other.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    AverageMetric,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    IdentityPreparator,
    WorkflowContext,
)
from predictionio_tpu_torch.data import store as event_store
from predictionio_tpu_torch.models.als import ALSParams, RatingsCOO, als_train, recommend
from predictionio_tpu_torch.utils import jaxpickle
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclass
class DataSourceParams:
    app_name: str = ""
    event_names: List[str] = field(default_factory=lambda: ["view", "buy"])


@dataclass
class TrainingData:
    """Columnar, index-mapped (user, item, weight) interactions (event
    order preserved for the leave-one-out eval split). ``interactions``
    materializes string tuples lazily for small-data consumers."""

    app_name: str
    user_idx: np.ndarray   # int32 [n], event order
    item_idx: np.ndarray   # int32 [n]
    weight: np.ndarray     # float32 [n] (buys count harder)
    user_ids: BiMap
    item_ids: BiMap
    item_categories: Dict[str, List[str]]

    @property
    def n(self) -> int:
        return int(self.user_idx.shape[0])

    @property
    def interactions(self) -> List[tuple]:
        u_inv = self.user_ids.inverse()
        i_inv = self.item_ids.inverse()
        return [(u_inv[int(u)], i_inv[int(i)], float(w))
                for u, i, w in zip(self.user_idx, self.item_idx,
                                   self.weight)]

    def subset(self, mask: np.ndarray) -> "TrainingData":
        """Rows where ``mask`` holds, vocabularies trimmed (eval-fold
        cold-entity rule — see ``data/pipeline.subset_columnar``)."""
        from predictionio_tpu_torch.data.pipeline import subset_columnar

        uu, ii, u_ids, i_ids, ww = subset_columnar(
            mask, self.user_idx, self.item_idx,
            self.user_ids, self.item_ids, self.weight)
        return TrainingData(self.app_name, uu, ii, ww, u_ids, i_ids,
                            self.item_categories)


class ECommDataSource(DataSource):
    ParamsClass = DataSourceParams

    def read_eval(self, ctx: WorkflowContext):
        """Leave-one-out over interactions: each user's LAST pair is
        held out and must be retrieved by the plain user query. Eval
        candidates must set ``unseenOnly: false`` — live seen-item
        exclusion reads the event store, which still contains the
        held-out event."""
        td = self.read_training(ctx)
        n_u = len(td.user_ids)
        counts = np.bincount(td.user_idx, minlength=n_u)
        last_row = np.full(n_u, -1, np.int64)
        last_row[td.user_idx] = np.arange(td.n)  # later rows overwrite
        held = np.sort(last_row[(last_row >= 0) & (counts >= 2)])
        if held.size == 0:
            raise ValueError("no user has >= 2 interactions to hold out")
        keep_mask = np.ones(td.n, bool)
        keep_mask[held] = False
        u_inv = td.user_ids.inverse()
        i_inv = td.item_ids.inverse()
        qa = [({"user": u_inv[int(td.user_idx[j])], "num": 10},
               i_inv[int(td.item_idx[j])]) for j in held]
        return [(td.subset(keep_mask), {"fold": 0}, qa)]

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        p: DataSourceParams = self.params
        data = event_store.read_training_interactions(
            p.app_name, entity_type="user", target_entity_type="item",
            event_names=p.event_names,
            value_spec={"buy": 4.0}, default_spec=1.0,
            storage=ctx.storage)
        uu, ii, ww = data.arrays()
        if uu.size == 0:
            raise ValueError("no view/buy events found")
        cats = {
            entity_id: list(props.get("categories") or [])
            for entity_id, props in event_store.aggregate_properties(
                p.app_name, "item", storage=ctx.storage).items()
        }
        return TrainingData(p.app_name, uu, ii, ww,
                            data.user_ids, data.item_ids, cats)


@dataclass
class ECommAlgorithmParams:
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # live-rule knobs (reference: unseenOnly, seenEvents, similarEvents)
    unseen_only: bool = True
    seen_events: List[str] = field(default_factory=lambda: ["view", "buy"])


# -- the blob's params pickle across packages ---------------------------------

#: the JAX package's module and name of the params class; the blob's
#: pickle names the class by it whichever package wrote it
JAX_PARAMS_GLOBAL = ("predictionio_tpu.templates.ecommercerecommendation.engine",
                     "ECommAlgorithmParams")


def dumps_blob(d: Dict[str, Any]) -> bytes:
    """Pickle the blob dict the way the JAX package's ``pickle.dumps``
    does, with the params class named by its JAX module path."""
    return jaxpickle.dumps(d, {ECommAlgorithmParams: JAX_PARAMS_GLOBAL})


def loads_blob(blob: bytes) -> Dict[str, Any]:
    return jaxpickle.loads(blob, {ECommAlgorithmParams: JAX_PARAMS_GLOBAL},
                           "e-commerce blob")


class ECommModel:
    def __init__(self, U: np.ndarray, V: np.ndarray, user_ids: BiMap,
                 item_ids: BiMap, item_categories: Dict[str, List[str]],
                 popularity: np.ndarray, app_name: str,
                 params: "ECommAlgorithmParams", device=None) -> None:
        self.U = U
        self.V = V
        self.user_ids = user_ids
        self.item_ids = item_ids
        self._inv = item_ids.inverse()
        self.item_categories = item_categories
        self.popularity = popularity  # per item index, for cold start
        self.app_name = app_name
        self.params = params
        self.device = device
        self._scorer = None

    def _device_scorer(self):
        """Lazy device-resident scorer for production-size catalogs
        (shared policy: ``models/als.maybe_resident_scorer``)."""
        from predictionio_tpu_torch.models.als import maybe_resident_scorer

        self._scorer = maybe_resident_scorer(self.U, self.V, self._scorer,
                                             device=self.device)
        return self._scorer

    # -- live lookups (host-side, storage at serving time) --------------------

    def _seen_items(self, user: str, storage) -> Set[str]:
        if not self.params.unseen_only:
            return set()
        evs = event_store.find_by_entity(
            self.app_name, "user", user,
            event_names=self.params.seen_events,
            target_entity_type="item", limit=None, storage=storage)
        return {e.target_entity_id for e in evs if e.target_entity_id}

    def _unavailable_items(self, storage) -> Set[str]:
        """Latest $set on the 'constraint' entity 'unavailableItems'
        (reference behavior: ops toggle availability live)."""
        snap = event_store.aggregate_properties(self.app_name, "constraint",
                                                storage=storage)
        pm = snap.get("unavailableItems")
        if pm is None:
            return set()
        return set(pm.get("items") or [])

    def query(self, user: str, num: int,
              categories: Optional[List[str]] = None,
              white_list: Optional[List[str]] = None,
              black_list: Optional[List[str]] = None,
              storage=None) -> List[Dict[str, Any]]:
        banned = self._unavailable_items(storage) | set(black_list or [])
        banned |= self._seen_items(user, storage)
        cats = set(categories or [])
        white = set(white_list or [])

        uidx = self.user_ids.get(user)
        if uidx is not None:
            fetch = min(len(self.item_ids), num + len(banned) + 50)
            scorer = self._device_scorer()
            if scorer is not None:
                top, scores = scorer.recommend(uidx, fetch)
            else:
                top, scores = recommend(self.U, self.V, uidx, fetch)
            ranked = [(self._inv[int(i)], float(s)) for i, s in zip(top, scores)]
        else:
            # cold start: popularity fallback (reference behavior)
            order = np.argsort(-self.popularity)
            ranked = [(self._inv[int(i)], float(self.popularity[i]))
                      for i in order]

        out = []
        for item, score in ranked:
            if item in banned:
                continue
            if white and item not in white:
                continue
            if cats and not cats.intersection(self.item_categories.get(item, [])):
                continue
            out.append({"item": item, "score": score})
            if len(out) >= num:
                break
        return out


class ECommAlgorithm(Algorithm):
    ParamsClass = ECommAlgorithmParams

    def sanity_check(self, data: TrainingData) -> None:
        if data.n == 0:
            raise ValueError("empty interactions")

    @staticmethod
    def _to_coo(pd: TrainingData) -> RatingsCOO:
        # weight aggregation by linearized (user, item) pair
        n_items = len(pd.item_ids)
        lin = pd.user_idx.astype(np.int64) * n_items + pd.item_idx
        uniq, inv = np.unique(lin, return_inverse=True)
        vv = np.bincount(inv, weights=pd.weight).astype(np.float32)
        return RatingsCOO((uniq // n_items).astype(np.int32),
                          (uniq % n_items).astype(np.int32), vv,
                          len(pd.user_ids), n_items)

    @staticmethod
    def _als_params(p: ECommAlgorithmParams) -> ALSParams:
        return ALSParams(rank=p.rank, iterations=p.num_iterations,
                         reg=p.lambda_, implicit=True, alpha=p.alpha,
                         seed=0 if p.seed is None else p.seed)

    def _model(self, pd: TrainingData, coo: RatingsCOO, U, V,
               p: ECommAlgorithmParams, device=None) -> ECommModel:
        popularity = np.bincount(coo.item_idx, weights=coo.rating,
                                 minlength=len(pd.item_ids))
        return ECommModel(U, V, pd.user_ids, pd.item_ids,
                          pd.item_categories,
                          popularity.astype(np.float32), pd.app_name, p,
                          device=device)

    @classmethod
    def train_many(cls, ctx: WorkflowContext, pd: TrainingData,
                   params_list) -> List[ECommModel]:
        """Grid fan-out (``pio eval``) on ``ctx.device``: one COO and one
        uploaded layout for every candidate (``models/als.als_train_many``)."""
        from predictionio_tpu_torch.models.als import als_train_many

        coo = cls._to_coo(pd)
        results = als_train_many(
            coo, [cls._als_params(p) for p in params_list], device=ctx.device,
            mesh=ctx.mesh)
        return [cls(p)._model(pd, coo, U, V, p, device=ctx.device)
                for p, (U, V) in zip(params_list, results)]

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> ECommModel:
        p: ECommAlgorithmParams = self.params
        coo = self._to_coo(pd)
        U, V = als_train(coo, self._als_params(p), device=self.device,
                         mesh=ctx.mesh)
        return self._model(pd, coo, U, V, p, device=self.device)

    def predict(self, model: ECommModel, query: Dict[str, Any]) -> Dict[str, Any]:
        return {"itemScores": model.query(
            str(query["user"]),
            int(query.get("num", 10)),
            query.get("categories"),
            query.get("whiteList"),
            query.get("blackList"),
            storage=self.serving_storage,  # live rules read the deploy Storage
        )}

    def save_model(self, model: ECommModel, instance_dir: Optional[str]) -> bytes:
        buf = io.BytesIO()
        np.savez_compressed(buf, U=model.U, V=model.V, pop=model.popularity)
        return dumps_blob({
            "npz": buf.getvalue(),
            "user_ids": model.user_ids.to_dict(),
            "item_ids": model.item_ids.to_dict(),
            "cats": model.item_categories,
            "app_name": model.app_name,
            "params": self.params,
        })

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]) -> ECommModel:
        if blob is None:
            raise ValueError("ECommAlgorithm.load_model needs the model blob")
        d = loads_blob(blob)
        arrs = np.load(io.BytesIO(d["npz"]))
        return ECommModel(arrs["U"], arrs["V"], BiMap(d["user_ids"]),
                          BiMap(d["item_ids"]), d["cats"], arrs["pop"],
                          d["app_name"], d["params"], device=self.device)


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=ECommDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"ecomm": ECommAlgorithm},
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box) -------------------------------------


class HitRateAtK(AverageMetric):
    def __init__(self, k: int = 10) -> None:
        self.k = k

    def calculate_one(self, query, predicted, actual) -> float:
        items = [s["item"] for s in predicted.get("itemScores", [])][: self.k]
        return 1.0 if actual in items else 0.0

    @property
    def header(self) -> str:
        return f"HitRate@{self.k}"


class ECommEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = HitRateAtK(10)


class DefaultGrid(EngineParamsGenerator):
    """rank/alpha candidates; unseenOnly stays FALSE for eval (see
    read_eval); app via $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        return [EngineParams(
            data_source_params=DataSourceParams(app_name=app),
            algorithms_params=[("ecomm", ECommAlgorithmParams(
                rank=r, num_iterations=10, alpha=a, unseen_only=False))])
            for r in (8, 16) for a in (1.0,)]
