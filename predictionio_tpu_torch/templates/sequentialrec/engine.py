"""Sequential Recommendation template: self-attentive next-item model.

The port of the JAX package's template of the same path
(:mod:`predictionio_tpu_torch.models.seq_rec`, SASRec-style):

- DataSource: interaction events (default ``view``/``buy``/``rate``)
  grouped per user, ordered by eventTime → item-id sequences.
- Algorithm: causal-transformer next-item model trained on the training
  device (CUDA unless the caller asks for the CPU); a ``meshConf`` mesh
  runs its attention as ring attention over the mesh's slots.
- Serving: the user's recent history is read LIVE from the event store
  at query time (``data/store.find_by_entity``), so new events shift
  predictions without retraining; the weights stay resident on the
  serving device in a module cached on the model.

    POST /queries.json {"user": "u1", "num": 4}
    → {"itemScores": [{"item": "i9", "score": 3.1}, ...]}

Optional query keys: ``history`` (explicit item list overriding the
live lookup — anonymous sessions), ``blackList``.

The blob is the JAX package's dict (numpy weights, the id map, the
``SeqRecParams`` and ``SeqRecAlgorithmParams`` dataclasses named by
their JAX module paths), so an instance either package trains deploys in
the other.
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
from predictionio_tpu_torch.data import store as event_store
from predictionio_tpu_torch.models.seq_rec import (
    SeqRecNet,
    SeqRecParams,
    seq_rec_params_from_jax,
    seq_rec_scores,
    seq_rec_train,
)
from predictionio_tpu_torch.utils import jaxpickle
from predictionio_tpu_torch.utils.bimap import BiMap
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass
class DataSourceParams:
    app_name: str = ""
    event_names: List[str] = field(
        default_factory=lambda: ["view", "buy", "rate"])


@dataclass
class TrainingData:
    app_name: str
    # per user: item ids ordered by event time (strings, raw)
    sequences: Dict[str, List[str]]


class SeqDataSource(DataSource):
    ParamsClass = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        """Stream events into columnar (user, item) arrays, then one
        STABLE sort by user groups each user's items. Time order inside
        each group comes for free: the EventStore.find contract is
        "ordered by eventTime asc", and a stable sort preserves it."""
        from predictionio_tpu_torch.data.store import read_training_interactions

        p: DataSourceParams = self.params
        data = read_training_interactions(
            p.app_name, entity_type="user", target_entity_type="item",
            event_names=p.event_names, storage=ctx.storage)
        uu, ii, _ones = data.arrays()
        if uu.size == 0:
            raise ValueError("no interaction events found")
        order = np.argsort(uu, kind="stable")
        uu, ii = uu[order], ii[order]
        i_inv = data.item_ids.inverse()
        u_inv = data.user_ids.inverse()
        seqs: Dict[str, List[str]] = {}
        bounds = np.concatenate(
            ([0], np.nonzero(np.diff(uu))[0] + 1, [uu.size]))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            seqs[u_inv[int(uu[lo])]] = [i_inv[int(j)] for j in ii[lo:hi]]
        return TrainingData(p.app_name, seqs)

    def read_eval(self, ctx: WorkflowContext):
        """Leave-one-out next-item evaluation (the standard SASRec
        protocol): each user's LAST item is held out; the query replays
        the remaining history through the anonymous-session path, so
        eval needs no serving-time storage."""
        td = self.read_training(ctx)
        train_seqs: Dict[str, List[str]] = {}
        qa = []
        for u, seq in td.sequences.items():
            if len(seq) >= 3:
                train_seqs[u] = seq[:-1]
                qa.append(({"history": seq[:-1], "num": 10}, seq[-1]))
            else:
                train_seqs[u] = seq
        if not qa:
            raise ValueError(
                "no user has a sequence of length ≥ 3 to hold out")
        return [(TrainingData(td.app_name, train_seqs), {"fold": 0}, qa)]


@dataclass
class SeqRecAlgorithmParams:
    hidden: int = 64
    num_blocks: int = 2
    num_heads: int = 2
    seq_len: int = 64
    epochs: int = 20
    lr: float = 1e-3
    batch_size: int = 128
    seed: int = 7
    # serving: which events form the live history
    history_events: List[str] = field(
        default_factory=lambda: ["view", "buy", "rate"])
    # sequential consumption is often repeat-friendly (music, groceries);
    # flip on to ban already-seen items like the ALS recommenders do
    exclude_seen: bool = False


class SeqRecModel:
    def __init__(self, params: Dict, item_ids: BiMap, app_name: str,
                 hp: SeqRecParams, algo_params: "SeqRecAlgorithmParams",
                 losses: np.ndarray, device=None) -> None:
        self.params = params      # the JAX package's nested numpy dict
        self.item_ids = item_ids  # raw item id → 0-based index (vocab id - 1)
        self._inv = item_ids.inverse()
        self.app_name = app_name
        self.hp = hp
        self.algo_params = algo_params
        self.losses = losses
        self.device = device
        self._net: Optional[SeqRecNet] = None

    def __getstate__(self):
        # the resident module's device tensors are not pickled
        d = dict(self.__dict__)
        d["_net"] = None
        return d

    @property
    def net(self) -> SeqRecNet:
        """The weights resident on the serving device, built on first use."""
        if self._net is None:
            self._net = seq_rec_params_from_jax(self.params, self.hp,
                                                resolve_device(self.device))
        return self._net

    def live_history(self, user: str, storage) -> List[str]:
        # only the last seq_len interactions can influence the model; with
        # exclude_seen the FULL history is needed to ban every seen item
        limit = None if self.algo_params.exclude_seen else self.hp.seq_len
        evs = event_store.find_by_entity(
            self.app_name, "user", user,
            event_names=self.algo_params.history_events,
            target_entity_type="item", limit=limit, latest=True,
            storage=storage)
        ordered = sorted(evs, key=lambda e: e.event_time)
        return [e.target_entity_id for e in ordered if e.target_entity_id]

    def next_items(self, history_raw: List[str], num: int,
                   black_list: Optional[List[str]] = None
                   ) -> List[Dict[str, Any]]:
        hist = [self.item_ids[i] + 1 for i in history_raw
                if i in self.item_ids]
        scores = seq_rec_scores(self.net, hist, self.hp)  # PAD = -inf
        banned = set(black_list or [])
        if self.algo_params.exclude_seen:
            banned |= set(history_raw)
        for raw in banned:  # ban by -inf, then one partial top-k on the host
            idx = self.item_ids.get(raw)
            if idx is not None:
                scores[idx + 1] = -np.inf
        num = min(num, len(self.item_ids))
        top = np.argpartition(-scores, num)[:num]
        top = top[np.argsort(-scores[top])]
        return [{"item": self._inv[int(i) - 1], "score": float(scores[i])}
                for i in top if np.isfinite(scores[i])]


#: the blob's dataclasses → the JAX package's names of them
JAX_NAMES = {
    SeqRecParams: ("predictionio_tpu.models.seq_rec", "SeqRecParams"),
    SeqRecAlgorithmParams: ("predictionio_tpu.templates.sequentialrec.engine",
                            "SeqRecAlgorithmParams"),
}


class SeqRecAlgorithm(Algorithm):
    ParamsClass = SeqRecAlgorithmParams

    def sanity_check(self, data: TrainingData) -> None:
        if not any(len(s) >= 2 for s in data.sequences.values()):
            raise ValueError("no user has a sequence of length ≥ 2")

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> SeqRecModel:
        p: SeqRecAlgorithmParams = self.params
        item_ids = BiMap.string_int(
            i for seq in pd.sequences.values() for i in seq)
        # vocab ids are 1-based (0 = PAD)
        sequences = [[item_ids[i] + 1 for i in seq]
                     for seq in pd.sequences.values()]
        # the workflow's per-run checkpoint dir enables mid-train
        # restart-from-checkpoint, like the ALS/two-tower templates
        ckpt_dir = None
        if ctx.checkpoint_dir:
            ckpt_dir = os.path.join(ctx.checkpoint_dir, "seq_rec")
        hp = SeqRecParams(hidden=p.hidden, num_blocks=p.num_blocks,
                          num_heads=p.num_heads, seq_len=p.seq_len,
                          epochs=p.epochs, lr=p.lr,
                          batch_size=p.batch_size, seed=p.seed,
                          checkpoint_dir=ckpt_dir)
        # meshConf routes attention through ring attention over the mesh's
        # sequence axis (falls back to local if seq_len doesn't divide)
        params, losses = seq_rec_train(sequences, len(item_ids), hp,
                                       mesh=ctx.mesh, device=self.device)
        return SeqRecModel(params, item_ids, pd.app_name, hp, p, losses,
                           device=self.device)

    def predict(self, model: SeqRecModel, query: Dict[str, Any]
                ) -> Dict[str, Any]:
        num = int(query.get("num", 10))
        if "history" in query:  # anonymous-session path
            history = [str(i) for i in query["history"]]
        else:
            history = model.live_history(str(query["user"]),
                                         self.serving_storage)
        return {"itemScores": model.next_items(
            history, num, query.get("blackList"))}

    def save_model(self, model: SeqRecModel, instance_dir: Optional[str]
                   ) -> bytes:
        return jaxpickle.dumps({
            "params": model.params,
            "item_ids": model.item_ids.to_dict(),
            "app_name": model.app_name,
            "hp": model.hp,
            "algo_params": model.algo_params,
            "losses": model.losses,
        }, JAX_NAMES)

    def load_model(self, blob: Optional[bytes],
                   instance_dir: Optional[str]) -> SeqRecModel:
        if blob is None:
            raise ValueError("SeqRecAlgorithm.load_model needs the model blob")
        d = jaxpickle.loads(blob, JAX_NAMES, "sequential recommendation blob")
        return SeqRecModel(d["params"], BiMap(d["item_ids"]), d["app_name"],
                           d["hp"], d["algo_params"], d["losses"],
                           device=self.device)


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=SeqDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"seqrec": SeqRecAlgorithm},
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box) -------------------------------------


class HitRate(AverageMetric):
    """1 if the held-out item appears in the top-k, else 0 — averaged
    over users (hit rate @ k, the SASRec leave-one-out metric)."""

    def __init__(self, k: int = 10) -> None:
        self.k = k

    def calculate_one(self, query, predicted, actual) -> float:
        items = [s["item"] for s in predicted.get("itemScores", [])][: self.k]
        return 1.0 if actual in items else 0.0

    @property
    def header(self) -> str:
        return f"HitRate@{self.k}"


class SeqRecEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = HitRate(10)
    other_metrics = (HitRate(1),)


def _candidate(app_name: str, hidden: int) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(app_name=app_name),
        algorithms_params=[("seqrec", SeqRecAlgorithmParams(
            hidden=hidden, num_blocks=1, num_heads=2, seq_len=32,
            epochs=30))],
    )


class DefaultGrid(EngineParamsGenerator):
    """Two hidden-size candidates. App name from $PIO_EVAL_APP_NAME:

        PIO_EVAL_APP_NAME=MyApp pio eval \\
          predictionio_tpu_torch.templates.sequentialrec.engine:SeqRecEvaluation \\
          predictionio_tpu_torch.templates.sequentialrec.engine:DefaultGrid
    """

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        return [_candidate(app, 32), _candidate(app, 64)]
