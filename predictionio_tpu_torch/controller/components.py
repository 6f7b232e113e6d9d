"""The DASE roles: DataSource, Preparator, Algorithm, Serving.

Model persistence contract, as in the JAX package: by default a trained
model is pickled into the model blob store; an Algorithm may override
``save_model``/``load_model`` to persist structured artifacts.
"""

from __future__ import annotations

import pickle
from abc import ABC, abstractmethod
from typing import Any, Generic, List, Optional, Sequence, TypeVar

TD = TypeVar("TD")   # training data
PD = TypeVar("PD")   # prepared data
M = TypeVar("M")     # model
Q = TypeVar("Q")     # query
PR = TypeVar("PR")   # prediction


class DataSource(ABC, Generic[TD]):
    """Reads training data from the event store."""

    def __init__(self, params: Any = None) -> None:
        self.params = params

    @abstractmethod
    def read_training(self, ctx: Any) -> TD:
        ...

    def read_eval(self, ctx: Any) -> List[tuple]:
        """Return ``[(training_data, eval_info, [(query, actual), ...]), ...]``
        — one tuple per fold (reference: PDataSource.readEval)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unavailable for this engine")


class Preparator(ABC, Generic[TD, PD]):
    def __init__(self, params: Any = None) -> None:
        self.params = params

    @abstractmethod
    def prepare(self, ctx: Any, training_data: TD) -> PD:
        ...


class IdentityPreparator(Preparator[TD, TD]):
    """Pass-through (reference: IdentityPreparator)."""

    def prepare(self, ctx: Any, training_data: TD) -> TD:
        return training_data


class Algorithm(ABC, Generic[PD, M, Q, PR]):
    """``train`` returns a local model; ``predict`` serves one query
    from the resident model."""

    def __init__(self, params: Any = None) -> None:
        self.params = params
        #: the torch device this algorithm trains on (set by Engine.train)
        #: or serves on (set by prepare_deploy); set_serving_context also
        #: gives it the serving process's Storage
        self.serving_storage: Any = None
        self.device: Any = None

    def set_serving_context(self, storage: Any, device: Any) -> None:
        """Called once at deploy time with the Storage backing this
        serving process and the device its models are served on."""
        self.serving_storage = storage
        self.device = device

    @abstractmethod
    def train(self, ctx: Any, prepared_data: PD) -> M:
        ...

    @abstractmethod
    def predict(self, model: M, query: Q) -> PR:
        ...

    #: True when ``batch_predict`` understands AOT-bucket ``PAD``
    #: sentinels (``server/aot.PAD``) inline — it must then return one
    #: (discarded) slot per PAD. False (default) → the deploy layer
    #: strips pads before calling and re-inserts the empty slots.
    accepts_padding: bool = False

    def batch_predict(self, model: M, queries: Sequence[Q]) -> List[PR]:
        """Bulk scoring; default maps ``predict``; algorithms override
        to batch onto the device."""
        return [self.predict(model, q) for q in queries]

    def aot_warm(self, model: M, ladder: Any,
                 ks: Sequence[int] = (16,)) -> Optional[dict]:
        """Deploy-time warmup hook (``server/aot.AOTWarmup``): warm this
        algorithm's serving program for every batch bucket in ``ladder``
        (× each top-k width in ``ks``). Return ``{"targets", "compiled",
        "cached"}`` counts, or None. Default: nothing to warm."""
        return None

    @classmethod
    def train_many(cls, ctx: Any, prepared_data: PD,
                   params_list: Sequence[Any]) -> List[M]:
        """Train one model per params on the SAME prepared data — the
        grid-search fan-out (``pio eval``), on ``ctx.device``. Default is
        sequential; an algorithm overrides it to share its per-dataset
        work (layout, upload) across the candidates."""
        models = []
        for p in params_list:
            algo = cls(p)
            algo.device = ctx.device
            models.append(algo.train(ctx, prepared_data))
        return models

    @classmethod
    def sweep_programs(cls, ctx: Any, prepared_data: PD,
                       params_list: Sequence[Any], qpa: Sequence[Any],
                       metric: Any) -> Optional[List[Any]]:
        """Distributed-sweep hook (``core/sweep.py``): return a list of
        ``SweepProgram``s that together cover every candidate in
        ``params_list`` — each a train+score program over a stacked
        hyperparameter axis, bucketed by geometry, on ``ctx.device`` — or
        None when this algorithm (or ``metric.sweep_kind``) can only run
        on the serial qpa path. ``qpa`` is the fold's ``[(q, a), ...]``."""
        return None

    def sanity_check(self, data: Any) -> None:
        """Hook mirroring the reference's SanityCheck trait: raise if the
        training data is degenerate (empty training set etc.)."""

    def save_model(self, model: M, instance_dir: Optional[str]) -> Optional[bytes]:
        return pickle.dumps(model)

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]) -> M:
        if blob is None:
            raise ValueError(
                f"{type(self).__name__}.load_model got no blob; override "
                "load_model to restore from the instance directory")
        return pickle.loads(blob)


class Serving(ABC, Generic[Q, PR]):
    """Combines per-algorithm predictions into the served response."""

    def __init__(self, params: Any = None) -> None:
        self.params = params

    @abstractmethod
    def serve(self, query: Q, predictions: List[PR]) -> PR:
        ...

    def supplement(self, query: Q) -> Q:
        """Pre-processing hook applied to the query before prediction."""
        return query


class FirstServing(Serving[Q, PR]):
    """Serve the first algorithm's prediction (reference: FirstServing)."""

    def serve(self, query: Q, predictions: List[PR]) -> PR:
        if not predictions:
            raise ValueError("no predictions to serve")
        return predictions[0]
