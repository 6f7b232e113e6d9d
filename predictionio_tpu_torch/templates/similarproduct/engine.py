"""Similar Product template: item-to-item similarity from implicit ALS.

Behavioral equivalent of the JAX package's template of the same path
(reference: [U] examples/scala-parallel-similarproduct/ — "view" events
→ implicit ALS; query = list of liked items → top-K cosine-similar
items, with category/whitelist/blacklist filters; SURVEY.md §2c).

    POST /queries.json {"items": ["i1", "i3"], "num": 4,
                        "categories": ["c1"], "blackList": ["i5"]}
    → {"itemScores": [{"item": "i2", "score": 0.87}, ...]}

Training runs implicit ALS on the card (``gather_gram`` with the
confidence weights, ``chol_solve`` with ``VᵀV`` on every system).
Serving scores catalogs of at least 2,048 items on the card, one
``score_topk`` launch a query over the resident normalised factors
(``models/als.similar_items_device``), smaller ones on the host; the
``PIO_ALS_SERVE`` policy is the other ALS templates'. The blob is the
JAX package's (a pickled dict), so an instance either package trains
deploys in the other.

Approximate retrieval (``ann: true``, engine.json ``annM``, ``annK``,
``annShortlist``): training builds a PQ index over the NORMALISED item
factors (``ann.build_index``, on the training device), so the ADC scan
and the exact re-rank compute cosine directly. The blob carries the
index's ``PIOANN01`` bytes, and a store with a directory also gets
``ann_index.bin`` with its sidecar and manifest beside ``model.bin``
(what ``pio index status`` reads); load prefers that file, verified. A
single-item query is one ANN dispatch (``ann.maybe_ann_scorer(Vn,
Vn)``: ``U[i] · V[j] = cos(v_i, v_j)``); multi-item queries take the
exact path above. Sharded ANN serving (``annShards`` > 1) is not ported
and raises at train and at load.
"""

from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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
from predictionio_tpu_torch.models.als import (
    ALSParams,
    RatingsCOO,
    als_train,
    similar_items,
    similar_items_device,
)
from predictionio_tpu_torch.utils.bimap import BiMap

@dataclass
class DataSourceParams:
    app_name: str = ""
    event_names: List[str] = field(default_factory=lambda: ["view"])


@dataclass
class TrainingData:
    """Columnar, index-mapped view events (event ORDER preserved for the
    last-view eval split). ``views`` materializes (user, item) string
    pairs lazily for small-data consumers."""

    user_idx: np.ndarray   # int32 [n], event order
    item_idx: np.ndarray   # int32 [n]
    user_ids: BiMap
    item_ids: BiMap
    item_categories: Dict[str, List[str]]  # from $set item properties

    @property
    def n(self) -> int:
        return int(self.user_idx.shape[0])

    @property
    def views(self) -> List[tuple]:
        u_inv = self.user_ids.inverse()
        i_inv = self.item_ids.inverse()
        return [(u_inv[int(u)], i_inv[int(i)])
                for u, i in zip(self.user_idx, self.item_idx)]

    def subset(self, mask: np.ndarray) -> "TrainingData":
        """Rows where ``mask`` holds, vocabularies trimmed (eval-fold
        cold-entity rule — see ``data/pipeline.subset_columnar``)."""
        from predictionio_tpu_torch.data.pipeline import subset_columnar

        uu, ii, u_ids, i_ids = subset_columnar(
            mask, self.user_idx, self.item_idx,
            self.user_ids, self.item_ids)
        return TrainingData(uu, ii, u_ids, i_ids, self.item_categories)


class SimilarProductDataSource(DataSource):
    ParamsClass = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        p: DataSourceParams = self.params
        data = event_store.read_training_interactions(
            p.app_name, entity_type="user", target_entity_type="item",
            event_names=p.event_names, storage=ctx.storage)
        uu, ii, _ones = data.arrays()
        if uu.size == 0:
            raise ValueError("no view events found; import events before training")
        cats = {
            entity_id: list(props.get("categories") or [])
            for entity_id, props in event_store.aggregate_properties(
                p.app_name, "item", storage=ctx.storage).items()
        }
        return TrainingData(uu, ii, data.user_ids, data.item_ids, cats)

    def read_eval(self, ctx: WorkflowContext):
        """Item-to-item retrieval protocol: each user's LAST viewed
        item is held out; the query carries the user's remaining items
        and the held-out one must rank in the top-k similars."""
        td = self.read_training(ctx)
        n_u = len(td.user_ids)
        counts = np.bincount(td.user_idx, minlength=n_u)
        last_row = np.full(n_u, -1, np.int64)
        last_row[td.user_idx] = np.arange(td.n)  # later rows overwrite
        held = np.sort(last_row[(last_row >= 0) & (counts >= 3)])
        if held.size == 0:
            raise ValueError("no user has >= 3 views to hold one out")
        keep_mask = np.ones(td.n, bool)
        keep_mask[held] = False
        i_inv = td.item_ids.inverse()
        held_users = set(td.user_idx[held].tolist())
        by_user: Dict[int, List[str]] = {}
        for u, i in zip(td.user_idx[keep_mask].tolist(),
                        td.item_idx[keep_mask].tolist()):
            if u in held_users:
                by_user.setdefault(u, []).append(i_inv[i])
        qa = [({"items": by_user[int(td.user_idx[j])], "num": 10},
               i_inv[int(td.item_idx[j])]) for j in held]
        return [(td.subset(keep_mask), {"fold": 0}, qa)]


@dataclass
class ALSAlgorithmParams:
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # -- approximate item-to-item retrieval (predictionio_tpu_torch/ann):
    # builds the PQ index over the NORMALIZED item factors at train
    # time, so the ADC scan + exact re-rank computes cosine directly.
    # engine.json spelling: ann, annM, annK, annShortlist, annShards.
    ann: bool = False
    ann_m: int = 5            # subspaces (must divide rank)
    ann_k: int = 256          # centroids per subspace
    ann_shortlist: int = 128  # k′ re-rank candidates
    ann_shards: int = 0       # serving-mesh width hint (> 1 is not ported)


class SimilarProductModel:
    def __init__(self, V: np.ndarray, item_ids: BiMap,
                 item_categories: Dict[str, List[str]],
                 ann_index=None, ann_shortlist: int = 128, ann_shards: int = 0,
                 device=None) -> None:
        self.V = V
        self.item_ids = item_ids
        self._inv = item_ids.inverse()
        self.item_categories = item_categories
        #: optional PQ index over the normalised factors (``ann``)
        self.ann_index = ann_index
        self.ann_shortlist = ann_shortlist
        self.ann_shards = ann_shards
        self.device = device
        self._Vn = None
        self._scorer = None
        self._ann_scorer = None

    def _device_scorer(self):
        """Lazy device-resident scorer of the normalised factors
        (``ResidentScorer(Vn, Vn)``) for production-size catalogs
        (shared policy: ``models/als.serve_on_device``)."""
        from predictionio_tpu_torch.models.als import (
            maybe_resident_scorer,
            normalized_rows,
        )

        if self._Vn is None:
            self._Vn = normalized_rows(self.V)
        self._scorer = maybe_resident_scorer(self._Vn, self._Vn, self._scorer,
                                             device=self.device)
        return self._scorer

    def _ann_device_scorer(self):
        """Lazy ANN scorer over the normalised corpus with itself as the
        query table: ``U[i] · V[j] = cos(v_i, v_j)``, so a single-item
        query is ONE ADC-shortlist dispatch. None without an index, or
        for a catalog the serving policy keeps on the host."""
        if self.ann_index is None:
            return None
        from predictionio_tpu_torch.ann import maybe_ann_scorer
        from predictionio_tpu_torch.models.als import normalized_rows

        if self._Vn is None:
            self._Vn = normalized_rows(self.V)
        self._ann_scorer = maybe_ann_scorer(
            self._Vn, self._Vn, self.ann_index, self._ann_scorer,
            shortlist=self.ann_shortlist, shards=self.ann_shards,
            device=self.device)
        return self._ann_scorer

    def query(self, items: List[str], num: int,
              categories: Optional[List[str]] = None,
              white_list: Optional[List[str]] = None,
              black_list: Optional[List[str]] = None) -> List[Dict[str, Any]]:
        idxs = np.asarray([self.item_ids[i] for i in items
                           if i in self.item_ids], np.int32)
        if idxs.size == 0:
            return []
        # over-fetch so post-filters still fill `num`
        fetch = min(len(self.item_ids), num + idxs.size + 50)
        ann = self._ann_device_scorer() if idxs.size == 1 else None
        if ann is not None:
            top, scores = ann.recommend(int(idxs[0]), fetch, exclude=idxs)
        elif (scorer := self._device_scorer()) is not None:
            top, scores = similar_items_device(scorer, self._Vn, idxs, fetch)
        else:
            top, scores = similar_items(self.V, idxs, fetch)
        cats = set(categories or [])
        white = set(white_list or [])
        black = set(black_list or [])
        out = []
        for i, s in zip(top, scores):
            item = self._inv[int(i)]
            if white and item not in white:
                continue
            if item in black:
                continue
            if cats and not cats.intersection(self.item_categories.get(item, [])):
                continue
            out.append({"item": item, "score": float(s)})
            if len(out) >= num:
                break
        return out


class ALSAlgorithm(Algorithm):
    ParamsClass = ALSAlgorithmParams

    def sanity_check(self, data: TrainingData) -> None:
        if data.n == 0:
            raise ValueError("empty view data")

    @staticmethod
    def _to_coo(pd: TrainingData) -> RatingsCOO:
        # repeat-view counts by linearized (user, item) pair
        n_items = len(pd.item_ids)
        lin = pd.user_idx.astype(np.int64) * n_items + pd.item_idx
        uniq, cnt = np.unique(lin, return_counts=True)
        return RatingsCOO((uniq // n_items).astype(np.int32),
                          (uniq % n_items).astype(np.int32),
                          cnt.astype(np.float32),
                          len(pd.user_ids), n_items)

    @staticmethod
    def _als_params(p: ALSAlgorithmParams) -> ALSParams:
        if p.ann and int(p.ann_shards or 0) > 1:
            from predictionio_tpu_torch.ann.scorer import SHARDED_NOT_PORTED

            raise ValueError(f"annShards {p.ann_shards}: {SHARDED_NOT_PORTED}")
        return ALSParams(rank=p.rank, iterations=p.num_iterations,
                         reg=p.lambda_, implicit=True, alpha=p.alpha,
                         seed=0 if p.seed is None else p.seed)

    @staticmethod
    def _maybe_index(V: np.ndarray, p: ALSAlgorithmParams, device):
        """PQ index over the NORMALIZED factors (cosine = inner product
        there), built on ``device``; None when ANN is off. A rank that
        does not split into ``ann_m`` subspaces raises, as in the JAX
        package."""
        if not p.ann:
            return None
        from predictionio_tpu_torch.ann.index import build_index
        from predictionio_tpu_torch.models.als import normalized_rows

        return build_index(normalized_rows(V), p.ann_m,
                           min(p.ann_k, max(2, V.shape[0])), device=device)

    @classmethod
    def train_many(cls, ctx: WorkflowContext, pd: TrainingData,
                   params_list) -> List[SimilarProductModel]:
        """Grid fan-out (``pio eval``) on ``ctx.device``: one COO and one
        uploaded layout for every candidate (``models/als.als_train_many``)."""
        from predictionio_tpu_torch.models.als import als_train_many

        als_params = [cls._als_params(p) for p in params_list]
        results = als_train_many(cls._to_coo(pd), als_params, device=ctx.device)
        return [SimilarProductModel(V, pd.item_ids, pd.item_categories,
                                    ann_index=cls._maybe_index(V, p, ctx.device),
                                    ann_shortlist=p.ann_shortlist,
                                    ann_shards=p.ann_shards, device=ctx.device)
                for p, (_, V) in zip(params_list, results)]

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> SimilarProductModel:
        p: ALSAlgorithmParams = self.params
        _, V = als_train(self._to_coo(pd), self._als_params(p),
                         device=self.device)
        return SimilarProductModel(V, pd.item_ids, pd.item_categories,
                                   ann_index=self._maybe_index(V, p, self.device),
                                   ann_shortlist=p.ann_shortlist,
                                   ann_shards=p.ann_shards, device=self.device)

    def predict(self, model: SimilarProductModel, query: Dict[str, Any]) -> Dict[str, Any]:
        return {"itemScores": model.query(
            [str(i) for i in query.get("items", [])],
            int(query.get("num", 10)),
            query.get("categories"),
            query.get("whiteList"),
            query.get("blackList"),
        )}

    # the JAX package's blob: a pickled dict of an npz of V, the item id
    # map, the categories, the ANN serving knobs and, with ANN, the
    # index's PIOANN01 bytes (plus the sidecar layout when the model
    # store has a directory)
    def save_model(self, model: SimilarProductModel, instance_dir: Optional[str]) -> bytes:
        buf = io.BytesIO()
        np.savez_compressed(buf, V=model.V)
        d = {
            "npz": buf.getvalue(),
            "item_ids": model.item_ids.to_dict(),
            "cats": model.item_categories,
            "ann_shortlist": model.ann_shortlist,
            "ann_shards": model.ann_shards,
        }
        if model.ann_index is not None:
            from predictionio_tpu_torch.ann.index import save_index

            d["ann_index"] = model.ann_index.to_bytes()
            if instance_dir:
                save_index(model.ann_index, instance_dir)
        return pickle.dumps(d)

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]) -> SimilarProductModel:
        if blob is None:
            raise ValueError("ALSAlgorithm.load_model needs the model blob")
        d = pickle.loads(blob)
        arrs = np.load(io.BytesIO(d["npz"]))
        from predictionio_tpu_torch.ann.scorer import load_blob_index

        ann_index = load_blob_index(d, instance_dir, d.get("ann_shards", 0))
        return SimilarProductModel(arrs["V"], BiMap(d["item_ids"]), d["cats"],
                                   ann_index=ann_index,
                                   ann_shortlist=d.get("ann_shortlist", 128),
                                   ann_shards=d.get("ann_shards", 0),
                                   device=self.device)


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=SimilarProductDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"als": ALSAlgorithm},
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


class SPEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = HitRateAtK(10)


class DefaultGrid(EngineParamsGenerator):
    """Rank candidates; app via $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        return [EngineParams(
            data_source_params=DataSourceParams(app_name=app),
            algorithms_params=[("als", ALSAlgorithmParams(rank=r))])
            for r in (8, 16)]
