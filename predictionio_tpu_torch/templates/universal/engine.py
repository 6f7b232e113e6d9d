"""Universal Recommender template: multi-event CCO + LLR indicators.

The port of the JAX package's template of the same path (the ActionML
Universal Recommender: LLR-thresholded co-occurrence of the primary
conversion event against every secondary event type, queried by user
history). The co-occurrence counts and the LLR run on the training
device (:mod:`predictionio_tpu_torch.models.cco`); the indicators stay
resident on the serving device and each user query is one device
program (:class:`~predictionio_tpu_torch.models.cco.CCOResidentScorer`).

    POST /queries.json {"user": "u1", "num": 4,
                        "eventBoosts": {"view": 0.5}}
    → {"itemScores": [{"item": "i2", "score": 12.3}, ...]}

Item-based queries are supported too: {"item": "i1", "num": 4} returns
the item's own-event indicators (similar items by LLR).

The blob is the JAX package's: the whole :class:`URModel` pickled, with
``URModel``, ``URAlgorithmParams`` and ``BiMap`` named by their JAX
module paths (``utils/jaxpickle``), so an instance either package trains
deploys in the other.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

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
from predictionio_tpu_torch.models.cco import (
    CCOParams,
    CCOResidentScorer,
    cco_indicators,
    cco_indicators_many,
)
from predictionio_tpu_torch.utils import jaxpickle
from predictionio_tpu_torch.utils.bimap import BiMap


@dataclass
class DataSourceParams:
    app_name: str = ""
    # first name is the primary (conversion) event, rest are secondary
    event_names: List[str] = field(default_factory=lambda: ["buy", "view"])


@dataclass
class TrainingData:
    """Columnar multi-event interactions with SHARED vocabularies
    (``data/pipeline.read_event_groups``; event order preserved per
    stream). ``events`` materializes the ``{name: [(user, item), …]}``
    string shape on first access (cached) for small-data consumers and
    tests."""

    app_name: str
    pairs: Dict[str, Tuple[np.ndarray, np.ndarray]]  # name → (uu, ii)
    user_ids: BiMap
    item_ids: BiMap

    @functools.cached_property
    def events(self) -> Dict[str, List[tuple]]:
        u_inv = self.user_ids.inverse()
        i_inv = self.item_ids.inverse()
        return {name: [(u_inv[int(u)], i_inv[int(i)])
                       for u, i in zip(uu, ii)]
                for name, (uu, ii) in self.pairs.items()}

    @classmethod
    def from_events(cls, app_name: str,
                    events: Dict[str, List[tuple]]) -> "TrainingData":
        """Build from the string-pair shape (tests/helpers)."""
        user_ids = BiMap.string_int(
            u for prs in events.values() for u, _ in prs)
        item_ids = BiMap.string_int(
            i for prs in events.values() for _, i in prs)
        pairs = {
            name: (np.asarray([user_ids[u] for u, _ in prs], np.int32),
                   np.asarray([item_ids[i] for _, i in prs], np.int32))
            for name, prs in events.items()}
        return cls(app_name, pairs, user_ids, item_ids)

    def subset_primary(self, primary: str,
                       keep_mask: np.ndarray) -> "TrainingData":
        """Drop primary rows where ``keep_mask`` is False and TRIM the
        shared vocabularies to entities still present in ANY event —
        an eval fold must not know held-out-only entities (they fall
        back to popularity at query time, the cold path)."""
        pairs = dict(self.pairs)
        uu, ii = pairs[primary]
        pairs[primary] = (uu[keep_mask], ii[keep_mask])
        all_u = [p[0] for p in pairs.values() if p[0].size]
        all_i = [p[1] for p in pairs.values() if p[1].size]
        used_u = (np.unique(np.concatenate(all_u)) if all_u
                  else np.zeros(0, np.int64))
        used_i = (np.unique(np.concatenate(all_i)) if all_i
                  else np.zeros(0, np.int64))
        lut_u = np.full(len(self.user_ids), -1, np.int32)
        lut_u[used_u] = np.arange(len(used_u), dtype=np.int32)
        lut_i = np.full(len(self.item_ids), -1, np.int32)
        lut_i[used_i] = np.arange(len(used_i), dtype=np.int32)
        u_inv = self.user_ids.inverse()
        i_inv = self.item_ids.inverse()
        return TrainingData(
            self.app_name,
            {name: (lut_u[p[0]], lut_i[p[1]])
             for name, p in pairs.items()},
            BiMap({u_inv[int(u)]: int(j) for j, u in enumerate(used_u)}),
            BiMap({i_inv[int(i)]: int(j) for j, i in enumerate(used_i)}))


class URDataSource(DataSource):
    ParamsClass = DataSourceParams

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        from predictionio_tpu_torch.data.store import read_training_event_groups

        p: DataSourceParams = self.params
        pairs, user_ids, item_ids = read_training_event_groups(
            p.app_name, p.event_names, storage=ctx.storage)
        if pairs[p.event_names[0]][0].size == 0:
            raise ValueError(
                f"no primary event {p.event_names[0]!r} found; import events first")
        return TrainingData(p.app_name, pairs, user_ids, item_ids)

    def read_eval(self, ctx: WorkflowContext):
        """Leave-one-out over the PRIMARY event (the Universal
        Recommender's standard offline protocol): each user's last
        conversion is held out; the trained model's stored user
        history then reflects only the remaining events, so the plain
        ``{"user": u}`` query evaluates honestly."""
        td = self.read_training(ctx)
        primary = self.params.event_names[0]
        uu, ii = td.pairs[primary]          # event-time order
        n_u = len(td.user_ids)
        counts = np.bincount(uu, minlength=n_u)
        last_row = np.full(n_u, -1, np.int64)
        last_row[uu] = np.arange(uu.size)   # later rows overwrite
        held = np.sort(last_row[(last_row >= 0) & (counts >= 2)])
        if held.size == 0:
            raise ValueError(
                "no user has ≥ 2 primary events to hold one out")
        keep_mask = np.ones(uu.size, bool)
        keep_mask[held] = False
        u_inv = td.user_ids.inverse()
        i_inv = td.item_ids.inverse()
        qa = [({"user": u_inv[int(uu[j])], "num": 10}, i_inv[int(ii[j])])
              for j in held]
        return [(td.subset_primary(primary, keep_mask), {"fold": 0}, qa)]


@dataclass
class URAlgorithmParams:
    max_indicators_per_item: int = 50
    llr_threshold: float = 0.0
    event_boosts: Dict[str, float] = field(default_factory=dict)
    # live exclusions at query time, like the reference's blacklistEvents
    blacklist_events: List[str] = field(default_factory=list)


class URModel:
    def __init__(self, indicators, user_history, item_ids: BiMap,
                 primary_event: str, params: URAlgorithmParams,
                 popularity: np.ndarray, device=None) -> None:
        self.indicators = indicators          # {event: (idxs, llr)}
        self.user_history = user_history      # {user: {event: [item_idx]}}
        self.item_ids = item_ids
        self._inv = item_ids.inverse()
        self.primary_event = primary_event
        self.params = params
        self.popularity = popularity
        self._scorer: Optional[CCOResidentScorer] = None
        #: the serving device (not pickled: the loading algorithm sets it)
        self._device = device

    def __getstate__(self):
        # the JAX package's attributes: device tensors don't serialize,
        # and the scorer rebuilds lazily after model load
        d = dict(self.__dict__)
        d["_scorer"] = None
        d.pop("_device", None)
        return d

    @property
    def scorer(self) -> CCOResidentScorer:
        """Device-resident scorer (built lazily: a model fresh out of
        deserialization gets its indicator arrays back onto the device on
        the first query)."""
        if getattr(self, "_scorer", None) is None:
            self._scorer = CCOResidentScorer(
                self.indicators, len(self.item_ids), self.popularity,
                device=getattr(self, "_device", None))
        return self._scorer

    def query_user(self, user: str, num: int,
                   boosts: Optional[Dict[str, float]] = None,
                   black_list: Optional[List[str]] = None) -> List[Dict[str, Any]]:
        hist = self.user_history.get(user) or {}
        banned = {self.item_ids[b] for b in (black_list or [])
                  if b in self.item_ids}
        # exclude the user's own primary-event items (don't re-recommend buys)
        banned.update(hist.get(self.primary_event, []))
        # ONE device program: bitmap+gather+sum+popularity-fallback+top-k
        hits = self.scorer.recommend(
            hist, num, boosts or self.params.event_boosts or None,
            banned=sorted(banned))
        return [{"item": self._inv[i], "score": score}
                for i, score in hits]

    def query_item(self, item: str, num: int) -> List[Dict[str, Any]]:
        iidx = self.item_ids.get(item)
        if iidx is None:
            return []
        idxs, vals = self.indicators[self.primary_event]
        out = []
        for j, v in zip(idxs[iidx], vals[iidx]):
            if np.isfinite(v) and len(out) < num:
                out.append({"item": self._inv[int(j)], "score": float(v)})
        return out


#: the port's classes of the blob → the JAX package's names of them
JAX_NAMES = {
    URModel: ("predictionio_tpu.templates.universal.engine", "URModel"),
    URAlgorithmParams: ("predictionio_tpu.templates.universal.engine",
                        "URAlgorithmParams"),
    BiMap: ("predictionio_tpu.utils.bimap", "BiMap"),
}


def dumps_blob(model: URModel) -> bytes:
    """Pickle the model whole, as the JAX package's default
    ``save_model`` does, under the JAX names (the per-user history, the
    bulk of it, through the C pickler)."""
    return jaxpickle.dumps(model, JAX_NAMES, plain=(model.user_history,))


def loads_blob(blob: bytes) -> URModel:
    return jaxpickle.loads(blob, JAX_NAMES, "universal recommender blob")


class URAlgorithm(Algorithm):
    ParamsClass = URAlgorithmParams

    def sanity_check(self, data: TrainingData) -> None:
        if not data.pairs:
            raise ValueError("no events")
        primary = next(iter(data.pairs))
        if data.pairs[primary][0].size == 0:
            # the trainer drops empty event streams, so an empty
            # PRIMARY would otherwise KeyError deep inside
            # train/train_many — degenerate candidates must fail here
            raise ValueError(
                f"no events for the primary event {primary!r}")

    @staticmethod
    def _prepare(pd: TrainingData):
        """The candidate-independent half of training: event pairs
        (already index-mapped by the streaming read), per-user history,
        popularity."""
        primary = next(iter(pd.pairs))
        user_ids, item_ids = pd.user_ids, pd.item_ids
        n_items = len(item_ids)
        event_pairs = {name: p for name, p in pd.pairs.items()
                       if p[0].size}
        # per-user per-event item history (string user keys — query
        # lookups come in as strings), grouped vectorized: stable sort
        # by user preserves each stream's event-time order
        u_inv = user_ids.inverse()
        user_history: Dict[str, Dict[str, List[int]]] = {}
        for name, (uu, ii) in event_pairs.items():
            order = np.argsort(uu, kind="stable")
            us, is_ = uu[order], ii[order]
            starts = np.concatenate(([0], np.nonzero(np.diff(us))[0] + 1))
            items = is_.tolist()    # Python ints, sliced per user below
            for u, lo, hi in zip(us[starts].tolist(), starts.tolist(),
                                 starts[1:].tolist() + [us.size]):
                user_history.setdefault(u_inv[u], {})[name] = items[lo:hi]
        _pu, pi = event_pairs[primary]
        popularity = np.bincount(pi, minlength=n_items).astype(np.float32)
        return (primary, user_ids, item_ids, n_items, event_pairs,
                user_history, popularity)

    @staticmethod
    def _cco_params(p: URAlgorithmParams) -> CCOParams:
        return CCOParams(max_indicators_per_item=p.max_indicators_per_item,
                         llr_threshold=p.llr_threshold)

    @classmethod
    def train_many(cls, ctx: WorkflowContext, pd: TrainingData,
                   params_list) -> List[URModel]:
        """Grid fan-out (`pio eval`): the id maps, event pairs and the
        co-occurrence COUNT matrices are computed once; each candidate
        pays only its own LLR threshold + top-k
        (``models/cco.cco_indicators_many``)."""
        (primary, user_ids, item_ids, n_items, event_pairs,
         user_history, popularity) = cls._prepare(pd)
        many = cco_indicators_many(
            event_pairs[primary], event_pairs, len(user_ids), n_items,
            {name: n_items for name in event_pairs},
            [cls._cco_params(p) for p in params_list], device=ctx.device)
        return [URModel(ind, user_history, item_ids, primary, p,
                        popularity, device=ctx.device)
                for p, ind in zip(params_list, many)]

    def train(self, ctx: WorkflowContext, pd: TrainingData) -> URModel:
        p: URAlgorithmParams = self.params
        (primary, user_ids, item_ids, n_items, event_pairs,
         user_history, popularity) = self._prepare(pd)
        indicators = cco_indicators(
            event_pairs[primary], event_pairs, len(user_ids), n_items,
            {name: n_items for name in event_pairs},
            self._cco_params(p), device=self.device)
        return URModel(indicators, user_history, item_ids, primary, p,
                       popularity, device=self.device)

    def predict(self, model: URModel, query: Dict[str, Any]) -> Dict[str, Any]:
        num = int(query.get("num", 10))
        if "item" in query:
            return {"itemScores": model.query_item(str(query["item"]), num)}
        return {"itemScores": model.query_user(
            str(query["user"]), num,
            query.get("eventBoosts"), query.get("blackList"))}

    def save_model(self, model: URModel, instance_dir: Optional[str]) -> bytes:
        return dumps_blob(model)

    def load_model(self, blob: Optional[bytes],
                   instance_dir: Optional[str]) -> URModel:
        if blob is None:
            raise ValueError("URAlgorithm.load_model needs the model blob")
        model = loads_blob(blob)
        model._device = self.device
        return model


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=URDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"ur": URAlgorithm},
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box; the UR ecosystem's MAP@k) -----------


class MAPatK(AverageMetric):
    """Mean average precision @ k with ONE held-out relevant item:
    1/rank if it appears in the top-k, else 0 — the UR's standard
    offline metric under leave-one-out."""

    def __init__(self, k: int = 10) -> None:
        self.k = k

    def calculate_one(self, query, predicted, actual) -> float:
        items = [s["item"] for s in predicted.get("itemScores", [])][: self.k]
        return 1.0 / (items.index(actual) + 1) if actual in items else 0.0

    @property
    def header(self) -> str:
        return f"MAP@{self.k}"


class UREvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = MAPatK(10)
    other_metrics = (MAPatK(1),)


class DefaultGrid(EngineParamsGenerator):
    """LLR-threshold candidates; app name via $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        return [EngineParams(
            data_source_params=DataSourceParams(app_name=app),
            algorithms_params=[("ur", URAlgorithmParams(
                llr_threshold=t))]) for t in (0.0, 2.0)]
