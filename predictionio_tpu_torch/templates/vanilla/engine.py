"""Vanilla template: the minimal skeleton to start a new engine from.

The port of the JAX package's template of the same path (the reference's
vanilla template): counts the app's events and echoes each query back
with the count. Copy this directory, rename, and fill in the four DASE
roles. It trains nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    FirstServing,
    IdentityPreparator,
    WorkflowContext,
)
from predictionio_tpu_torch.data import store as event_store


@dataclass
class DataSourceParams:
    app_name: str = ""


class VanillaDataSource(DataSource):
    ParamsClass = DataSourceParams

    def read_training(self, ctx: WorkflowContext):
        return list(event_store.find(self.params.app_name, storage=ctx.storage))


@dataclass
class AlgoParams:
    mult: int = 1


class VanillaAlgorithm(Algorithm):
    ParamsClass = AlgoParams

    def train(self, ctx: WorkflowContext, events) -> Dict[str, Any]:
        return {"event_count": len(events) * self.params.mult}

    def predict(self, model: Dict[str, Any], query: Dict[str, Any]) -> Dict[str, Any]:
        return {"query": query, "eventCount": model["event_count"]}


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=VanillaDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={"algo": VanillaAlgorithm},
        serving_cls=FirstServing,
    )
