"""Recommendation template: ALS collaborative filtering, served on the card.

Behavioral equivalent of the JAX package's template of the same path
(reference: [U] examples/scala-parallel-recommendation/, SURVEY.md §2c),
with the same query/response wire shapes:

    POST /queries.json  {"user": "1", "num": 4}
    → {"itemScores": [{"item": "22", "score": 4.5}, ...]}

and the same model blob (a pickle holding an npz of U and V and the two
id maps), so an instance trained by either package deploys in the
other. This slice of the port serves; ``ALSAlgorithm.train`` is the next
slice (ROADMAP.md, queue 1, slice 2).
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
)
from predictionio_tpu_torch.models.als import recommend
from predictionio_tpu_torch.utils.bimap import BiMap

_TRAIN_LATER = ("ALS training is not ported yet: it is slice 2 of the port "
                "(ROADMAP.md, queue 1). Train with the JAX package's "
                "`pio train`; this package deploys what it wrote.")


@dataclass
class DataSourceParams:
    """The JAX template's data-source params, so a stored variant's
    ``datasource`` block parses here."""

    app_name: str = ""
    event_names: List[str] = field(default_factory=lambda: ["rate", "buy"])
    buy_rating: float = 4.0
    eval_k: int = 0
    eval_seed: int = 3
    event_window: Optional[Dict[str, Any]] = None


class RecDataSource(DataSource):
    """Carries :class:`DataSourceParams`; reading events for training
    comes with the training slice."""

    ParamsClass = DataSourceParams

    def read_training(self, ctx):
        raise NotImplementedError(_TRAIN_LATER)


@dataclass
class ALSAlgorithmParams:
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: Optional[int] = None
    implicit_prefs: bool = False
    alpha: float = 1.0
    checkpoint_every: int = 5
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

    def train(self, ctx, pd):
        raise NotImplementedError(_TRAIN_LATER)

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
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"als": ALSAlgorithm},
        serving_cls=FirstServing,
    )
