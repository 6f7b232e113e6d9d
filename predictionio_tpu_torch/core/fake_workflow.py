"""FakeWorkflow: run an arbitrary function through the workflow shell.

The port's counterpart of the JAX package's ``core/fake_workflow.py``
(the reference's FakeWorkflow): tests and evaluation tricks run a bare
function with the full workflow bracketing (instance row, status
transitions, context construction) but no DASE components. The function
takes the :class:`WorkflowContext` (storage, device, mesh), and the run
is recorded as an EngineInstance with factory ``fake:<label>``, so the
meta-store lifecycle is exercised as a real train exercises it: INIT →
TRAINING → COMPLETED, or FAILED.
"""

from __future__ import annotations

import traceback
from typing import Any, Callable, Optional

from predictionio_tpu_torch.controller.base import WorkflowContext
from predictionio_tpu_torch.parallel.mesh import make_mesh
from predictionio_tpu_torch.storage.meta import EngineInstance, utcnow
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils.device import resolve_device


def fake_run(
    fn: Callable[[WorkflowContext], Any],
    storage: Optional[Storage] = None,
    use_mesh: bool = False,
    verbose: int = 0,
    label: str = "fake",
    device=None,
) -> Any:
    """Execute ``fn(ctx)`` under workflow bracketing; returns its result.
    The context's device is ``device`` (CUDA unless the caller passes
    ``"cpu"``); ``use_mesh`` puts every device of its type on the
    context's mesh. The EngineInstance row ends COMPLETED or FAILED like
    a real train."""
    device = resolve_device(device)
    storage = storage or get_storage()
    instance_id = storage.meta.new_instance_id()
    ei = EngineInstance(
        id=instance_id, status="INIT", start_time=utcnow(), end_time=None,
        engine_factory=f"fake:{label}", engine_variant="", batch=label,
        env={}, mesh_conf={}, data_source_params="{}",
        preparator_params="{}", algorithms_params="[]", serving_params="{}",
    )
    storage.meta.insert_engine_instance(ei)
    mesh = make_mesh(platform=device.type) if use_mesh else None
    ctx = WorkflowContext(storage=storage, device=device, verbose=verbose,
                          instance_id=instance_id, mesh=mesh)
    try:
        ei.status = "TRAINING"
        storage.meta.update_engine_instance(ei)
        result = fn(ctx)
        ei.status = "COMPLETED"
        ei.end_time = utcnow()
        storage.meta.update_engine_instance(ei)
        return result
    except Exception:
        ei.status = "FAILED"
        ei.end_time = utcnow()
        storage.meta.update_engine_instance(ei)
        traceback.print_exc()
        raise
