"""Engine: binds the four DASE roles; params arrive separately (from
``engine.json``, a stored engine instance, or an evaluation's grid), so
one engine trains under many parameter variants (``pio eval``)."""

from __future__ import annotations

import importlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from predictionio_tpu_torch.controller.base import (
    WorkflowContext,
    params_from_json,
    params_to_json,
)
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
        if ctx.stop_after_read:
            return []
        t0 = time.perf_counter()
        with tracing.span("train.prepare"):
            prep = self.preparator_cls(engine_params.preparator_params)
            pd = prep.prepare(ctx, td)
        ctx.timings["prepare"] = time.perf_counter() - t0
        ctx.log("prepare done")
        if ctx.stop_after_prepare:
            return []
        models = []
        for name, algo in self.make_algorithms(engine_params):
            algo.device = ctx.device
            if not ctx.skip_sanity_check:
                algo.sanity_check(pd)
            ctx.log(f"training algorithm {name!r}")
            t0 = time.perf_counter()
            with tracing.span("train.fit", algorithm=name):
                models.append(algo.train(ctx, pd))
            ctx.timings[f"train:{name}"] = time.perf_counter() - t0
            ctx.log(f"algorithm {name!r} trained")
        return models

    def eval(
        self, ctx: WorkflowContext, engine_params: EngineParams,
        cache: Optional["FastEvalCache"] = None,
    ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per fold: train on the fold's training split, predict the fold's
        (query, actual) pairs → ``[(eval_info, [(q, p, a), ...]), ...]``
        (reference: Engine.eval producing RDD[(Q,P,A)] per fold)."""
        return self.eval_batch(ctx, [engine_params], cache)[0]

    def eval_batch(
        self, ctx: WorkflowContext, candidates: Sequence[EngineParams],
        cache: Optional["FastEvalCache"] = None,
    ) -> List[List[Tuple[Any, List[Tuple[Any, Any, Any]]]]]:
        """Evaluate several candidates on ``ctx.device``, sharing the
        expensive pipeline prefixes (the reference's FastEvalEngine,
        SURVEY.md §2d P4):

        - ``read_eval`` folds are computed once per distinct
          dataSourceParams, ``prepare`` once per (dataSourceParams,
          preparatorParams, fold) — memoized in ``cache`` so the reuse
          also spans separate ``eval_batch`` calls;
        - per fold, each algorithm slot trains ALL candidates that share
          the (dsp, pp) prefix through ONE ``Algorithm.train_many`` call.

        Returns per-candidate eval data, in input order.
        """
        cache = cache if cache is not None else FastEvalCache()
        out: List[Optional[list]] = [None] * len(candidates)

        # group candidates by shared (dsp, pp, algorithm slots) prefix,
        # preserving order — only same-slot candidates can train through
        # one train_many call. Cache keys carry the COMPONENT CLASS too:
        # one cache may serve several engines, and params alone would
        # collide across engines whose params serialize identically.
        groups: Dict[Tuple[str, str, Tuple[str, ...]], List[int]] = {}
        for i, ep in enumerate(candidates):
            groups.setdefault(self.group_key(cache, ep), []).append(i)

        for (ds_key, pp_key, names), idxs in groups.items():
            ep0 = candidates[idxs[0]]
            folds = cache.folds(
                ds_key,
                lambda: self.data_source_cls(
                    ep0.data_source_params).read_eval(ctx))
            prep = self.preparator_cls(ep0.preparator_params)
            results: List[list] = [[] for _ in idxs]
            for f, (td, eval_info, qa) in enumerate(folds):
                pd = cache.prepared(ds_key, pp_key, f,
                                    lambda: prep.prepare(ctx, td))
                # per algorithm slot: one train_many over the group
                models_by_cand: List[list] = [[] for _ in idxs]
                for slot, name in enumerate(names):
                    cls = self.algorithm_cls_map[name]
                    plist = [candidates[i].algorithms_params[slot][1]
                             for i in idxs]
                    # every candidate's params get checked: a degenerate
                    # candidate must fail here, not deep inside training
                    if not ctx.skip_sanity_check:
                        for p in plist:
                            cls(p).sanity_check(pd)
                    models = cls.train_many(ctx, pd, plist)
                    for j, m in enumerate(models):
                        models_by_cand[j].append(m)
                for j, i in enumerate(idxs):
                    ep = candidates[i]
                    serving = self.serving_cls(ep.serving_params)
                    algos = self.make_algorithms(ep)
                    for _, algo in algos:
                        algo.device = ctx.device
                    queries = [serving.supplement(q) for q, _ in qa]
                    per_algo = [
                        algo.batch_predict(model, queries)
                        for (_, algo), model in zip(algos, models_by_cand[j])
                    ]
                    qpa = [
                        (q, serving.serve(q, [preds[qi] for preds in per_algo]), a)
                        for qi, (q, a) in enumerate(
                            zip(queries, (a for _, a in qa)))
                    ]
                    results[j].append((eval_info, qpa))
            for j, i in enumerate(idxs):
                out[i] = results[j]
        return out  # type: ignore[return-value]

    def group_key(self, cache: "FastEvalCache", ep: EngineParams
                  ) -> Tuple[str, str, Tuple[str, ...]]:
        """The (data source, preparator, algorithm slots) prefix a
        candidate shares with the others of its group; the first two are
        also its ``cache`` keys."""
        def cls_key(c) -> str:
            return f"{c.__module__}:{c.__qualname__}"

        return (cls_key(self.data_source_cls) + "|"
                + cache.params_key(ep.data_source_params),
                cls_key(self.preparator_cls) + "|"
                + cache.params_key(ep.preparator_params),
                tuple(n for n, _ in ep.algorithms_params))


class FastEvalCache:
    """Memoizes the eval pipeline's expensive prefixes across grid
    candidates: dataSourceParams → folds, (dsp, pp, fold) → PreparedData
    (the reference's FastEvalEngine workflow caching). ``stats`` counts
    misses (i.e. actual reads/prepares) and hits for tests and logs.

    Contracts the sharing imposes (same as the reference's FastEval):

    - entries are SNAPSHOTS of the event data at first read — create a
      fresh cache after ingesting new events (MetricEvaluator already
      creates one per evaluate() call);
    - folds/PreparedData are shared across candidates and cache hits,
      so preparators and algorithms must not mutate them in place."""

    def __init__(self) -> None:
        self._folds: Dict[str, list] = {}
        self._prepared: Dict[Tuple[str, str, int], Any] = {}
        self.stats = {"read_eval": 0, "read_eval_hits": 0,
                      "prepare": 0, "prepare_hits": 0}

    @staticmethod
    def params_key(params: Any) -> str:
        try:
            return json.dumps(params_to_json(params), sort_keys=True,
                              default=str)
        except TypeError:
            # params types outside the JSON contract (plain classes)
            # still evaluate — they just key by repr, so equal-looking
            # instances won't share cache entries
            return repr(params)

    def folds(self, ds_key: str, compute) -> list:
        if ds_key not in self._folds:
            self.stats["read_eval"] += 1
            self._folds[ds_key] = compute()
        else:
            self.stats["read_eval_hits"] += 1
        return self._folds[ds_key]

    def prepared(self, ds_key: str, pp_key: str, fold: int, compute) -> Any:
        key = (ds_key, pp_key, fold)
        if key not in self._prepared:
            self.stats["prepare"] += 1
            self._prepared[key] = compute()
        else:
            self.stats["prepare_hits"] += 1
        return self._prepared[key]


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
