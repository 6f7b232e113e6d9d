"""Two-Tower deep retrieval template.

The port of the JAX package's template of the same path: user and item
towers (``models/two_tower``, PyTorch) trained with in-batch contrastive
loss on positive interaction events, served by cosine retrieval over the
precomputed item-embedding table.

    POST /queries.json {"user": "u1", "num": 4}
    → {"itemScores": [{"item": "i2", "score": 0.93}, ...]}

Training runs on the training device (CUDA unless the caller asks for
the CPU), data-parallel over the slots of a ``meshConf`` mesh of more
than one slot. Serving precomputes both embedding tables and scores on the
device through the ALS family's scorers: the exact ``ResidentScorer``
(one ``score_topk`` launch a batch) or, with ``ann: true``, the
``ANNScorer`` over a PQ index built at train time (ADC shortlist + exact
re-rank, no ``score_topk``); catalogs under 2,048 items score on the
host (the ``PIO_ALS_SERVE`` policy). ``annShards`` above 1 (or
``PIO_ANN_SHARDS``) serves the index item-sharded over that many slots.
An unknown user gets ``[]``.

The blob is the JAX package's (a pickled dict with the flax-format
``user_vars``, the item table, the id maps, the ``TwoTowerParams``
dataclass named by its JAX module path, and the index's ``PIOANN01``
bytes), so an instance either package trains deploys in the other; the
user table is recomputed on load.
"""

from __future__ import annotations

import os
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
from predictionio_tpu_torch.models.two_tower import (
    TwoTowerParams,
    two_tower_embed_items,
    two_tower_embed_users,
    two_tower_train,
    two_tower_user_embed,
)
from predictionio_tpu_torch.utils import jaxpickle
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclass
class DataSourceParams:
    app_name: str = ""
    event_names: List[str] = field(default_factory=lambda: ["view", "buy"])
    # >0 selects the streaming train path with this chunk size (events
    # per columnar chunk); 0 materializes pairs in host RAM
    stream_chunk: int = 0


@dataclass
class TrainingData:
    interactions: Any   # data.pipeline.InteractionData
    stream: bool = False  # True → trainer consumes chunks, not arrays


class TTDataSource(DataSource):
    ParamsClass = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Columnar read through the streaming pipeline in both modes;
        ``stream_chunk > 0`` additionally keeps the data chunked end to
        end (memory O(chunk + vocabulary); the trainer double-buffers
        chunks onto the device)."""
        from predictionio_tpu_torch.data.store import read_training_interactions

        p: DataSourceParams = self.params
        data = read_training_interactions(
            p.app_name, entity_type="user", target_entity_type="item",
            event_names=p.event_names,
            chunk_size=p.stream_chunk or 65536,
            # an explicit streaming request means the log may exceed host
            # memory: keep O(chunk) over the materializing columnar scan
            prefer_streaming=p.stream_chunk > 0,
            storage=ctx.storage)
        if data.n_events == 0:
            raise ValueError("no interaction events found")
        return TrainingData(data, stream=p.stream_chunk > 0)

    def read_eval(self, ctx: WorkflowContext):
        """Leave-one-out retrieval evaluation: each user's LAST
        interaction is held out of training and must be retrieved by
        the ``{"user": u}`` query (recall@k under one relevant item)."""
        from predictionio_tpu_torch.data.pipeline import InteractionData

        td = self.read_training(ctx)
        u, i, v = td.interactions.arrays()
        last: Dict[int, int] = {}
        cnt: Dict[int, int] = {}
        for idx, uu in enumerate(u.tolist()):
            last[uu] = idx
            cnt[uu] = cnt.get(uu, 0) + 1
        held = sorted(idx for uu, idx in last.items() if cnt[uu] >= 2)
        if not held:
            raise ValueError("no user has ≥ 2 interactions to hold out")
        keep = np.ones(len(u), bool)
        keep[held] = False
        uk, ik, vk = u[keep], i[keep], v[keep]
        reduced = InteractionData(
            td.interactions.user_ids, td.interactions.item_ids,
            lambda: iter([(uk, ik, vk)]), int(len(uk)))
        inv_u = td.interactions.user_ids.inverse()
        inv_i = td.interactions.item_ids.inverse()
        qa = [({"user": inv_u[int(u[idx])], "num": 10},
               inv_i[int(i[idx])]) for idx in held]
        return [(TrainingData(reduced, stream=False), {"fold": 0}, qa)]


@dataclass
class TTAlgorithmParams:
    embed_dim: int = 32
    out_dim: int = 32
    hidden: List[int] = field(default_factory=lambda: [64])
    batch_size: int = 1024
    epochs: int = 5
    learning_rate: float = 0.01
    temperature: float = 0.1
    seed: int = 0
    # mid-train checkpoint/resume; None = the workflow's directory
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    # -- approximate retrieval (predictionio_tpu_torch/ann): ``ann``
    # builds a PQ index at train time and serves ADC-shortlist + exact
    # re-rank. engine.json spelling: annM, annK, annIters, annShortlist,
    # annSample, annOpq, annShards.
    ann: bool = False
    ann_m: int = 8            # subspaces (must divide out_dim)
    ann_k: int = 256          # centroids per subspace (≤ 256, uint8 codes)
    ann_iters: int = 8        # Lloyd iterations
    ann_shortlist: int = 128  # k′ re-rank candidates (recall knob)
    ann_sample: int = 65536   # codebook training sample bound
    # OPQ learned rotation before quantization — better recall at the
    # same code bytes; versions the blob to v2
    ann_opq: bool = False
    # serving-mesh width hint: > 1 partitions the corpus item-wise over
    # a "shards" mesh axis at serving time
    ann_shards: int = 0


class TwoTowerModel:
    def __init__(self, user_vars, item_embeds: np.ndarray, user_ids: BiMap,
                 item_ids: BiMap, params: TwoTowerParams,
                 user_embeds: Optional[np.ndarray] = None,
                 ann_index=None, ann_shortlist: int = 128,
                 ann_shards: int = 0, device=None) -> None:
        self.user_vars = user_vars
        self.item_embeds = item_embeds
        self.user_ids = user_ids
        self.item_ids = item_ids
        self._inv = item_ids.inverse()
        self.params = params
        # both towers materialized → serving rides the ALS family's
        # device scorers; load_model recomputes this from user_vars, so
        # it is None only for hand-built models
        self.user_embeds = user_embeds
        #: optional PQ retrieval index built at train time; when present
        #: the device scorer serves ADC-shortlist + exact re-rank
        self.ann_index = ann_index
        self.ann_shortlist = ann_shortlist
        self.ann_shards = ann_shards
        self.device = device
        self._scorer = None

    def _device_scorer(self):
        """Lazy device scorer: ANN (ADC shortlist + re-rank) when the
        model carries a PQ index, else the exact resident scorer
        (models/als) — both keep the AOT-ladder / pad-masking serving
        contract, and both defer to the host path on small catalogs."""
        if self.user_embeds is None:
            return None
        from predictionio_tpu_torch.ann.scorer import ANNScorer, maybe_ann_scorer
        from predictionio_tpu_torch.models.als import maybe_resident_scorer

        if self.ann_index is not None:
            s = maybe_ann_scorer(self.user_embeds, self.item_embeds,
                                 self.ann_index, self._scorer,
                                 shortlist=self.ann_shortlist,
                                 shards=self.ann_shards, device=self.device)
            if s is not None:
                self._scorer = s
                return s
        cached = (None if isinstance(self._scorer, ANNScorer)
                  else self._scorer)
        self._scorer = maybe_resident_scorer(
            self.user_embeds, self.item_embeds, cached, device=self.device)
        return self._scorer

    def recommend(self, user: str, num: int) -> List[Dict[str, Any]]:
        # unknown user → an empty result on EVERY path (exact, ANN and
        # host), which the server returns as 200 {"itemScores": []}
        uidx = self.user_ids.get(user)
        if uidx is None:
            return []
        scorer = self._device_scorer()
        if scorer is not None:
            iv, vv = scorer.recommend(uidx, num)
            return [{"item": self._inv[int(i)], "score": float(s)}
                    for i, s in zip(iv, vv)]
        ue = (self.user_embeds[uidx] if self.user_embeds is not None else
              two_tower_user_embed(self.user_vars, uidx,
                                   len(self.user_ids), self.params))
        scores = self.item_embeds @ ue
        num = min(num, scores.shape[0])
        top = np.argpartition(-scores, num - 1)[:num]
        top = top[np.argsort(-scores[top])]
        return [{"item": self._inv[int(i)], "score": float(scores[i])}
                for i in top]


# -- the blob's params pickle across packages ---------------------------------

#: the JAX package's module and name of the params class; the blob's
#: pickle names the class by it whichever package wrote it
JAX_PARAMS_GLOBAL = ("predictionio_tpu.models.two_tower", "TwoTowerParams")


def dumps_blob(d: Dict[str, Any]) -> bytes:
    """Pickle the blob dict the way the JAX package's ``pickle.dumps``
    does, with the params class named by its JAX module path."""
    return jaxpickle.dumps(d, {TwoTowerParams: JAX_PARAMS_GLOBAL})


def loads_blob(blob: bytes) -> Dict[str, Any]:
    return jaxpickle.loads(blob, {TwoTowerParams: JAX_PARAMS_GLOBAL},
                           "two-tower blob")


class TwoTowerAlgorithm(Algorithm):
    ParamsClass = TTAlgorithmParams

    def sanity_check(self, data: TrainingData) -> None:
        if data.interactions is None or data.interactions.n_events == 0:
            raise ValueError("empty training pairs")

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> TwoTowerModel:
        p: TTAlgorithmParams = self.params
        user_ids = pd.interactions.user_ids
        item_ids = pd.interactions.item_ids
        if pd.stream:
            uidx = np.zeros(0, np.int32)
            iidx = np.zeros(0, np.int32)
        else:
            uidx, iidx, _ = pd.interactions.arrays()
        # explicit checkpoint_dir param wins; else the workflow's
        # per-run checkpoint dir enables restart-from-checkpoint
        ckpt_dir = p.checkpoint_dir
        if ckpt_dir is None and ctx.checkpoint_dir:
            ckpt_dir = os.path.join(ctx.checkpoint_dir, "two_tower")
        tp = TwoTowerParams(
            embed_dim=p.embed_dim, hidden=list(p.hidden), out_dim=p.out_dim,
            batch_size=p.batch_size, epochs=p.epochs,
            learning_rate=p.learning_rate, temperature=p.temperature,
            seed=p.seed, checkpoint_dir=ckpt_dir,
            checkpoint_every=p.checkpoint_every,
            n_pairs=pd.interactions.n_events)
        uv, iv = two_tower_train(
            uidx, iidx, len(user_ids), len(item_ids), tp,
            mesh=ctx.mesh,
            pair_chunks=(pd.interactions.chunks if pd.stream else None),
            device=self.device)
        item_embeds = two_tower_embed_items(iv, len(item_ids), tp)
        user_embeds = two_tower_embed_users(uv, len(user_ids), tp)
        ann_index = None
        if p.ann:
            from predictionio_tpu_torch.models.two_tower import two_tower_build_index

            ann_index = two_tower_build_index(
                item_embeds, m=p.ann_m, k=p.ann_k, iters=p.ann_iters,
                seed=p.seed, sample=p.ann_sample, opq=p.ann_opq,
                shards=p.ann_shards, device=self.device)
        return TwoTowerModel(uv, item_embeds, user_ids, item_ids, tp,
                             user_embeds=user_embeds, ann_index=ann_index,
                             ann_shortlist=p.ann_shortlist,
                             ann_shards=p.ann_shards, device=self.device)

    def predict(self, model: TwoTowerModel, query: Dict[str, Any]) -> Dict[str, Any]:
        return {"itemScores": model.recommend(str(query["user"]),
                                              int(query.get("num", 10)))}

    #: serve_topk_batch skips AOT-bucket PAD sentinels inline
    accepts_padding = True

    def batch_predict(self, model: TwoTowerModel,
                      queries) -> List[Dict[str, Any]]:
        """Micro-batched serving (``deploy --batching``, batchpredict):
        all queries in ONE device dispatch via the shared
        ``models/als.serve_topk_batch``."""
        from predictionio_tpu_torch.models.als import serve_topk_batch

        return serve_topk_batch(
            model._device_scorer(), model.user_ids, model._inv,
            queries, fallback=lambda q: self.predict(model, q))

    def aot_warm(self, model: TwoTowerModel, ladder, ks=(16,)):
        """Warm the serving program (exact or ANN) across the bucket
        ladder; host-path catalogs have nothing to warm."""
        scorer = model._device_scorer()
        if scorer is None:
            return {"targets": 0, "compiled": 0, "cached": 0}
        return scorer.warm_buckets(ladder, ks)

    def save_model(self, model: TwoTowerModel, instance_dir: Optional[str]) -> bytes:
        # user_embeds is not persisted: load recomputes it from
        # user_vars. The PQ index rides INSIDE the blob as its
        # self-verifying PIOANN01 bytes and, when the store has a real
        # directory, ALSO as ann_index.bin + .sha256 + manifest beside
        # model.bin (what `pio index status` reads)
        d = {
            "user_vars": model.user_vars,
            "item_embeds": model.item_embeds,
            "user_ids": model.user_ids.to_dict(),
            "item_ids": model.item_ids.to_dict(),
            "params": model.params,
            "ann_shortlist": model.ann_shortlist,
            "ann_shards": model.ann_shards,
        }
        if model.ann_index is not None:
            from predictionio_tpu_torch.ann.index import save_index

            d["ann_index"] = model.ann_index.to_bytes()
            if instance_dir:
                save_index(model.ann_index, instance_dir)
        return dumps_blob(d)

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]) -> TwoTowerModel:
        from predictionio_tpu_torch.ann.scorer import load_blob_index

        if blob is None:
            raise ValueError("TwoTowerAlgorithm.load_model needs the model blob")
        d = loads_blob(blob)
        user_ids = BiMap(d["user_ids"])
        # index integrity is verified on EVERY load; an IntegrityError
        # propagates to prepare_deploy → /reload refuses the candidate
        ann_index = load_blob_index(d, instance_dir)
        return TwoTowerModel(d["user_vars"], d["item_embeds"],
                             user_ids, BiMap(d["item_ids"]), d["params"],
                             user_embeds=two_tower_embed_users(
                                 d["user_vars"], len(user_ids), d["params"]),
                             ann_index=ann_index,
                             ann_shortlist=d.get("ann_shortlist", 128),
                             ann_shards=d.get("ann_shards", 0),
                             device=self.device)


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=TTDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"twotower": TwoTowerAlgorithm},
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box) -------------------------------------


class RecallAtK(AverageMetric):
    """With one held-out relevant item, recall@k = hit rate @ k."""

    def __init__(self, k: int = 10) -> None:
        self.k = k

    def calculate_one(self, query, predicted, actual) -> float:
        items = [s["item"] for s in predicted.get("itemScores", [])][: self.k]
        return 1.0 if actual in items else 0.0

    @property
    def header(self) -> str:
        return f"Recall@{self.k}"


class TTEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = RecallAtK(10)
    other_metrics = (RecallAtK(1),)


class DefaultGrid(EngineParamsGenerator):
    """Embedding-width candidates; app name via $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        return [EngineParams(
            data_source_params=DataSourceParams(app_name=app),
            algorithms_params=[("twotower", TTAlgorithmParams(
                embed_dim=d, out_dim=d, hidden=[2 * d], batch_size=256,
                epochs=30))]) for d in (16, 32)]


class ANNGrid(EngineParamsGenerator):
    """Exact-vs-ANN candidates under the same Recall@10 metric: the
    exact candidate is the recall ceiling, the ANN candidates show what
    each shortlist point costs in held-out retrieval quality.

    App name via $PIO_EVAL_APP_NAME; shortlist points via
    $PIO_EVAL_ANN_SHORTLISTS (comma-separated, default "64,128")."""

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        shortlists = [
            int(s) for s in os.environ.get(
                "PIO_EVAL_ANN_SHORTLISTS", "64,128").split(",") if s]
        base = dict(embed_dim=32, out_dim=32, hidden=[64], batch_size=256,
                    epochs=30)
        cands = [TTAlgorithmParams(**base)]          # exact ceiling
        cands += [TTAlgorithmParams(**base, ann=True, ann_m=8,
                                    ann_shortlist=sl)
                  for sl in shortlists]
        return [EngineParams(
            data_source_params=DataSourceParams(app_name=app),
            algorithms_params=[("twotower", c)]) for c in cands]
