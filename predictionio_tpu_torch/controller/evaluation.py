"""Evaluation: metrics and the grid-search evaluator.

The port's copy of the JAX package's ``controller/evaluation.py``
(reference: [U] core/.../controller/{Evaluation,Metric,AverageMetric,
MetricEvaluator,EngineParamsGenerator}.scala, SURVEY.md §3.4).
``MetricEvaluator`` runs the engine over every candidate EngineParams
through ``Engine.eval_batch`` (folds read once, each fold prepared once,
each algorithm slot trained through one ``train_many`` call) and picks
the best by the primary metric. ``MetricEvaluatorResult.to_json`` writes
the JAX package's JSON keys, so the evaluation instance rows of both
packages read alike.
"""

from __future__ import annotations

import json
import math
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.controller.base import WorkflowContext, params_to_json
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    EngineParams,
    FastEvalCache,
)


def ranking_key(metric: "Metric", score: float) -> float:
    """Ordering key shared by MetricEvaluator and core/sweep: NaN ranks
    last (-inf, never poisons a max), otherwise sign-normalized so a
    larger key is always better."""
    if math.isnan(score):
        return -math.inf
    return score if metric.higher_is_better else -score


class Metric(ABC):
    """Scores one evaluation run: ``[(eval_info, [(q, p, a), ...]), ...]``."""

    #: larger is better when True (reference: Metric.compare ordering)
    higher_is_better: bool = True

    #: Name of the device-side statistic family this metric can consume
    #: on the distributed sweep path (core/sweep.py), e.g. "sq_err"; the
    #: template's ``sweep_programs`` checks it to pick (or refuse) a
    #: scoring program. None → serial path only.
    sweep_kind: Optional[str] = None

    def sweep_finalize(self, stat_sum: float, stat_count: float) -> float:
        """Fold a device ``(stat_sum, stat_count)`` pair into this
        metric's score. Default: the mean (the AverageMetric family);
        zero count → NaN, matching the empty-scores serial convention."""
        if stat_count <= 0:
            return float("nan")
        return float(stat_sum) / float(stat_count)

    @abstractmethod
    def calculate(
        self, ctx: WorkflowContext,
        eval_data: List[Tuple[Any, List[Tuple[Any, Any, Any]]]],
    ) -> float:
        ...

    @property
    def header(self) -> str:
        return type(self).__name__


class AverageMetric(Metric):
    """Mean of a per-(q,p,a) score over all folds (reference: AverageMetric)."""

    @abstractmethod
    def calculate_one(self, query: Any, predicted: Any, actual: Any) -> float:
        ...

    def calculate(self, ctx, eval_data):
        scores = [
            self.calculate_one(q, p, a)
            for _, qpa in eval_data
            for q, p, a in qpa
        ]
        return float(sum(scores) / len(scores)) if scores else float("nan")


class OptionAverageMetric(AverageMetric):
    """Like AverageMetric but per-item scores of None are excluded
    (reference: OptionAverageMetric)."""

    @abstractmethod
    def calculate_one_opt(self, query: Any, predicted: Any, actual: Any) -> Optional[float]:
        ...

    def calculate_one(self, query, predicted, actual):  # pragma: no cover
        raise NotImplementedError

    def calculate(self, ctx, eval_data):
        scores = [
            s for _, qpa in eval_data for q, p, a in qpa
            if (s := self.calculate_one_opt(q, p, a)) is not None
        ]
        return float(sum(scores) / len(scores)) if scores else float("nan")


class SumMetric(Metric):
    """Sum of per-(q,p,a) scores (reference: SumMetric)."""

    @abstractmethod
    def calculate_one(self, query: Any, predicted: Any, actual: Any) -> float:
        ...

    def calculate(self, ctx, eval_data):
        return float(sum(
            self.calculate_one(q, p, a)
            for _, qpa in eval_data for q, p, a in qpa
        ))


class ZeroMetric(Metric):
    """Always 0 — placeholder for secondary-metric slots (reference: ZeroMetric)."""

    def calculate(self, ctx, eval_data):
        return 0.0


class EngineParamsGenerator:
    """Supplies candidate EngineParams for the grid search (reference:
    EngineParamsGenerator trait). Subclass and set ``engine_params_list``."""

    engine_params_list: List[EngineParams] = []


@dataclass
class MetricEvaluatorResult:
    best_score: float
    best_engine_params: EngineParams
    best_index: int
    # one (params, primary score, other scores) per candidate
    candidates: List[Tuple[EngineParams, float, List[float]]] = field(default_factory=list)

    def to_json(self) -> str:
        def ep_json(ep: EngineParams):
            return {
                "dataSourceParams": params_to_json(ep.data_source_params),
                "preparatorParams": params_to_json(ep.preparator_params),
                "algorithmsParams": [
                    {"name": n, "params": params_to_json(p)}
                    for n, p in ep.algorithms_params
                ],
                "servingParams": params_to_json(ep.serving_params),
            }

        return json.dumps({
            "bestScore": self.best_score,
            "bestIndex": self.best_index,
            "bestEngineParams": ep_json(self.best_engine_params),
            "candidates": [
                {"engineParams": ep_json(ep), "score": s, "otherScores": os}
                for ep, s, os in self.candidates
            ],
        }, indent=2)


class MetricEvaluator:
    """Grid search: evaluate every candidate, pick the best (reference:
    MetricEvaluator.evaluateBase)."""

    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = ()) -> None:
        self.metric = metric
        self.other_metrics = list(other_metrics)

    def evaluate(
        self,
        ctx: WorkflowContext,
        engine: Engine,
        candidates: Sequence[EngineParams],
    ) -> MetricEvaluatorResult:
        if not candidates:
            raise ValueError("no candidate engine params to evaluate")
        # candidates share read_eval/prepare through the cache, and
        # same-prefix candidates train through one train_many call
        cache = FastEvalCache()
        eval_datas = engine.eval_batch(ctx, candidates, cache)
        rows: List[Tuple[EngineParams, float, List[float]]] = []
        for i, (ep, eval_data) in enumerate(zip(candidates, eval_datas)):
            score = self.metric.calculate(ctx, eval_data)
            others = [m.calculate(ctx, eval_data) for m in self.other_metrics]
            ctx.log(f"candidate {i}: {self.metric.header}={score}")
            rows.append((ep, score, others))
        ctx.log(f"fast-eval cache: {cache.stats}")

        def key(i: int) -> float:
            return ranking_key(self.metric, rows[i][1])

        best_i = max(range(len(rows)), key=key)
        best = rows[best_i]
        return MetricEvaluatorResult(
            best_score=best[1], best_engine_params=best[0],
            best_index=best_i, candidates=rows)


class Evaluation:
    """Binds an engine to the evaluator (reference: Evaluation trait).

    Templates subclass and set ``engine_factory`` (spec string or callable
    returning Engine) and ``metric`` (plus optional ``other_metrics``).
    """

    engine_factory: Any = None
    metric: Optional[Metric] = None
    other_metrics: Sequence[Metric] = ()

    def get_engine(self) -> Engine:
        ef = self.engine_factory
        if isinstance(ef, str):
            return EngineFactory.create(ef)
        if callable(ef):
            engine = ef()
            if isinstance(engine, Engine):
                return engine
        if isinstance(ef, Engine):
            return ef
        raise TypeError("Evaluation.engine_factory must be a spec string, "
                        "callable, or Engine")

    def run(
        self, ctx: WorkflowContext, candidates: Sequence[EngineParams]
    ) -> MetricEvaluatorResult:
        if self.metric is None:
            raise ValueError("Evaluation.metric not set")
        evaluator = MetricEvaluator(self.metric, self.other_metrics)
        return evaluator.evaluate(ctx, self.get_engine(), candidates)
