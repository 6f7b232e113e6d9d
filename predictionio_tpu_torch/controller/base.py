"""Params plumbing and the workflow context.

Template parameter classes are plain dataclasses; :func:`params_from_json`
builds one from an ``engine.json`` params block, accepting both
snake_case and the reference's camelCase key spellings (and ``lambda``
for ``lambda_``, since the reference's ALS template uses the raw word) —
the same resolution as the JAX package, so a variant stored by one
package's train rebuilds the same params in the other's deploy.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field, is_dataclass
from typing import Any, Dict, Optional, Type, TypeVar

import torch

from predictionio_tpu_torch.storage.registry import Storage, get_storage


P = TypeVar("P")

_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


def _snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


def params_from_json(cls: Type[P], obj: Optional[Dict[str, Any]]) -> P:
    """Instantiate a params dataclass from a JSON dict.

    Key resolution order: exact field name → camelCase→snake_case
    normalization → trailing-underscore escape for Python keywords
    (``lambda`` → ``lambda_``). Unknown keys raise.
    """
    obj = obj or {}
    if not is_dataclass(cls):
        if cls in (dict, Dict):  # type: ignore[comparison-overlap]
            return dict(obj)  # type: ignore[return-value]
        return cls(**obj)  # type: ignore[call-arg]
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    for key, value in obj.items():
        cand = None
        if key in fields:
            cand = key
        else:
            sk = _snake(key)
            if sk in fields:
                cand = sk
            elif sk + "_" in fields:  # e.g. lambda -> lambda_
                cand = sk + "_"
        if cand is None:
            raise ValueError(
                f"unknown parameter {key!r} for {cls.__name__}; "
                f"known: {sorted(fields)}")
        kwargs[cand] = value
    return cls(**kwargs)  # type: ignore[call-arg]


def params_to_json(params: Any) -> Dict[str, Any]:
    if params is None:
        return {}
    if is_dataclass(params) and not isinstance(params, type):
        return dataclasses.asdict(params)
    if isinstance(params, dict):
        return dict(params)
    raise TypeError(f"cannot serialize params of type {type(params).__name__}")


@dataclass
class WorkflowContext:
    """Carried through every DASE stage of a train run.

    ``storage`` gives data sources the event and meta repositories;
    ``device`` is the torch device the algorithms train on (None: CUDA,
    raising when there is no card, ``utils/device.resolve_device``);
    per-phase wall-clock seconds land in ``timings``.
    ``checkpoint_dir`` is where iterative trainers keep mid-train
    checkpoints (``run_train`` points it at a per-(factory, variant)
    directory; None turns checkpointing off). ``mesh`` is the run's
    ``parallel/mesh.Mesh`` (None: one device), which the ALS templates
    train sharded over when it has more than one slot."""

    storage: Storage = field(default_factory=get_storage)
    device: Optional[torch.device] = None
    verbose: int = 0
    timings: Dict[str, float] = field(default_factory=dict)
    instance_id: str = ""
    checkpoint_dir: Optional[str] = None
    mesh: Optional[Any] = None

    def log(self, msg: str) -> None:
        if self.verbose:
            print(f"[workflow {self.instance_id or '-'}] {msg}", flush=True)

    def checkpointer(self, name: str):
        """A TrainCheckpointer under ``checkpoint_dir/name`` (None when
        checkpointing is off for this run)."""
        if not self.checkpoint_dir:
            return None
        from predictionio_tpu_torch.utils.checkpoint import TrainCheckpointer

        return TrainCheckpointer(os.path.join(self.checkpoint_dir, name))
