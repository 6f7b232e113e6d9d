"""Engine: binds the four DASE roles; params arrive separately (from
``engine.json`` or a stored engine instance)."""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple, Type

from predictionio_tpu_torch.controller.base import WorkflowContext, params_from_json
from predictionio_tpu_torch.controller.components import (
    Algorithm,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Preparator,
    Serving,
)


@dataclass
class EngineParams:
    """One full parameterization of an engine (reference: EngineParams)."""

    data_source_params: Any = None
    preparator_params: Any = None
    # list of (algorithm name, params) — order defines prediction order
    algorithms_params: List[Tuple[str, Any]] = field(default_factory=list)
    serving_params: Any = None


class Engine:
    def __init__(
        self,
        data_source_cls: Type[DataSource],
        preparator_cls: Type[Preparator],
        algorithm_cls_map: Dict[str, Type[Algorithm]],
        serving_cls: Type[Serving],
    ) -> None:
        self.data_source_cls = data_source_cls
        self.preparator_cls = preparator_cls or IdentityPreparator
        self.algorithm_cls_map = dict(algorithm_cls_map)
        self.serving_cls = serving_cls or FirstServing

    def _param_cls(self, component_cls: Type, default: Any = dict) -> Any:
        return getattr(component_cls, "ParamsClass", default)

    def params_from_variant(self, variant: Dict[str, Any]) -> EngineParams:
        """Build EngineParams from a parsed engine.json dict (the variant
        format of the reference: datasource/preparator/algorithms/serving
        blocks each holding a ``params`` object)."""
        dsp_json = (variant.get("datasource") or {}).get("params")
        pp_json = (variant.get("preparator") or {}).get("params")
        sp_json = (variant.get("serving") or {}).get("params")
        algos_json = variant.get("algorithms") or []
        dsp = params_from_json(self._param_cls(self.data_source_cls), dsp_json)
        pp = params_from_json(self._param_cls(self.preparator_cls), pp_json)
        sp = params_from_json(self._param_cls(self.serving_cls), sp_json)
        algos: List[Tuple[str, Any]] = []
        for block in algos_json:
            name = block.get("name")
            if name not in self.algorithm_cls_map:
                raise ValueError(
                    f"unknown algorithm {name!r}; engine defines "
                    f"{sorted(self.algorithm_cls_map)}")
            acls = self.algorithm_cls_map[name]
            algos.append((name, params_from_json(self._param_cls(acls),
                                                 block.get("params"))))
        if not algos:
            if len(self.algorithm_cls_map) == 1:
                # default: sole algorithm with default params
                name = next(iter(self.algorithm_cls_map))
                algos = [(name, params_from_json(
                    self._param_cls(self.algorithm_cls_map[name]), None))]
            else:
                raise ValueError(
                    "engine defines multiple algorithms "
                    f"({sorted(self.algorithm_cls_map)}); the variant must "
                    "list which to use in its 'algorithms' block")
        return EngineParams(dsp, pp, algos, sp)

    def make_algorithms(self, engine_params: EngineParams) -> List[Tuple[str, Algorithm]]:
        return [
            (name, self.algorithm_cls_map[name](params))
            for name, params in engine_params.algorithms_params
        ]

    def train(self, ctx: WorkflowContext, engine_params: EngineParams) -> List[Any]:
        """readTraining → prepare → sanity check → each algorithm's train
        (reference: Engine.train). Returns models in algorithms order;
        per-phase wall-clock lands in ``ctx.timings``."""
        from predictionio_tpu_torch.utils import tracing

        t0 = time.perf_counter()
        with tracing.span("train.read"):
            ds = self.data_source_cls(engine_params.data_source_params)
            td = ds.read_training(ctx)
        ctx.timings["read_training"] = time.perf_counter() - t0
        ctx.log("read_training done")
        t0 = time.perf_counter()
        with tracing.span("train.prepare"):
            prep = self.preparator_cls(engine_params.preparator_params)
            pd = prep.prepare(ctx, td)
        ctx.timings["prepare"] = time.perf_counter() - t0
        ctx.log("prepare done")
        models = []
        for name, algo in self.make_algorithms(engine_params):
            algo.device = ctx.device
            algo.sanity_check(pd)
            ctx.log(f"training algorithm {name!r}")
            t0 = time.perf_counter()
            with tracing.span("train.fit", algorithm=name):
                models.append(algo.train(ctx, pd))
            ctx.timings[f"train:{name}"] = time.perf_counter() - t0
            ctx.log(f"algorithm {name!r} trained")
        return models


class EngineFactory:
    """Resolver for ``"module.path:callable"`` engine-factory strings."""

    @staticmethod
    def resolve(spec: str) -> Callable[[], Engine]:
        module, sep, attr = spec.partition(":")
        if not sep or not module or not attr:
            raise ValueError(f"engine factory {spec!r} is not 'module:callable'")
        obj: Any = importlib.import_module(module)
        for part in attr.split("."):
            obj = getattr(obj, part)
        return obj

    @staticmethod
    def create(spec: str) -> Engine:
        engine = EngineFactory.resolve(spec)()
        if not isinstance(engine, Engine):
            raise TypeError(f"engine factory {spec!r} returned {type(engine).__name__}")
        return engine
