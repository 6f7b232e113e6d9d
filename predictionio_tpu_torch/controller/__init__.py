"""The DASE controller API the port's templates program against."""

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
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    EngineParams,
    FastEvalCache,
)
from predictionio_tpu_torch.controller.evaluation import (
    AverageMetric,
    EngineParamsGenerator,
    Evaluation,
    Metric,
    MetricEvaluator,
    MetricEvaluatorResult,
    OptionAverageMetric,
    SumMetric,
    ZeroMetric,
)

__all__ = [
    "params_from_json", "params_to_json", "WorkflowContext", "DataSource",
    "Preparator", "IdentityPreparator", "Algorithm", "Serving",
    "FirstServing", "Engine", "EngineFactory", "EngineParams",
    "FastEvalCache", "Metric", "AverageMetric", "OptionAverageMetric",
    "SumMetric", "ZeroMetric", "EngineParamsGenerator", "MetricEvaluator",
    "MetricEvaluatorResult", "Evaluation",
]
