"""The sharded sweep (``pio eval --distributed --sweep-shards N``) of the
port against the JAX package's ``sweep_shards=4`` (``tests/test_sweep.py``
``test_sweep_shards``): each bucket's stacked rows are dealt out over the
slots of a ``"shards"`` mesh, each slot's sub-grid runs on its device, and
the scores equal the unsharded sweep's. The slots are set as every mesh of
the port sets them: ``parallel/distributed.initialize(slots=...)``, here
one CPU named ``n`` times.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from predictionio_tpu.controller.base import WorkflowContext as JaxWorkflowContext
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.core.sweep import run_sweep as jax_run_sweep
from predictionio_tpu.templates.recommendation import engine as jax_rec
from predictionio_tpu_torch.controller import EngineParams, WorkflowContext
from predictionio_tpu_torch.core.sweep import run_sweep
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.templates.recommendation import engine as port_rec
from tests.test_sweep import ToyEvaluation as JaxToyEvaluation
from tests.test_sweep import _toy_candidates as jax_toy_candidates
from tests.test_sweep import toy_factory as jax_toy_factory
from tests.test_torch_eval import (
    GRID,
    RTOL,
    ToyNegRMSE,
    _cands,
    _jax_storage,
    _port_storage,
    _scores,
    _toy_candidates,
    homes,  # noqa: F401 (the module fixture)
    toy_factory,
)

SCALES = [0.5, 1.0, 2.0, 3.0, 1.5]


@contextlib.contextmanager
def cpu_slots(n: int):
    """This process's mesh slots: the one CPU, ``n`` times."""
    distributed.initialize(slots=["cpu"] * n)
    try:
        yield
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("shards", [2, 4])
def test_toy_sweep_sharded_like_the_jax_packages(tmp_path, shards):
    ctx = WorkflowContext(storage=_port_storage(str(tmp_path)), device="cpu")
    base = run_sweep(ctx, toy_factory(), _toy_candidates(SCALES), ToyNegRMSE())
    with cpu_slots(shards):
        mine = run_sweep(ctx, toy_factory(), _toy_candidates(SCALES), ToyNegRMSE(),
                         sweep_shards=shards)
    theirs = jax_run_sweep(
        JaxWorkflowContext(storage=_jax_storage(str(tmp_path))), jax_toy_factory(),
        jax_toy_candidates(SCALES), JaxToyEvaluation.metric, sweep_shards=shards)
    assert mine.shards == theirs.shards == shards and base.shards == 0
    assert _scores(mine.result) == _scores(base.result)
    np.testing.assert_allclose(_scores(mine.result), _scores(theirs.result),
                               rtol=1e-6, atol=1e-6)
    assert mine.fold_scores == base.fold_scores
    for key in ("buckets", "compiles", "dispatches", "vmapped", "serial", "shards"):
        assert mine.stats()[key] == theirs.stats()[key], key


def test_default_pool_is_the_context_devices_and_too_small_warns(tmp_path):
    ctx = WorkflowContext(storage=_port_storage(str(tmp_path)), device="cpu")
    with pytest.warns(RuntimeWarning, match="mesh needs 2 devices, have 1"):
        res = run_sweep(ctx, toy_factory(), _toy_candidates([1.0, 3.0]),
                        ToyNegRMSE(), sweep_shards=2)
    assert res.shards == 0
    # slots given to the distributed runtime are the pool, as for run_train
    with cpu_slots(2):
        res = run_sweep(ctx, toy_factory(), _toy_candidates([1.0, 3.0]),
                        ToyNegRMSE(), sweep_shards=2)
    assert res.shards == 2


def test_als_grid_sharded_equals_unsharded_and_the_jax_packages(homes):  # noqa: F811
    cands = _cands(port_rec, EngineParams, GRID)
    ctx = WorkflowContext(storage=_port_storage(homes["port"]), device="cpu")
    base = run_sweep(ctx, port_rec.engine_factory(), cands, port_rec.NegRMSE())
    with cpu_slots(2):
        mine = run_sweep(ctx, port_rec.engine_factory(), cands, port_rec.NegRMSE(),
                         sweep_shards=2)
    theirs = jax_run_sweep(
        JaxWorkflowContext(storage=_jax_storage(homes["jax"])),
        jax_rec.engine_factory(), _cands(jax_rec, JaxEngineParams, GRID),
        jax_rec.NegRMSE(), sweep_shards=4)
    assert (mine.shards, theirs.shards) == (2, 4)
    assert mine.fold_scores == base.fold_scores
    assert _scores(mine.result) == _scores(base.result)
    np.testing.assert_allclose(_scores(mine.result), _scores(theirs.result), rtol=RTOL)
    assert mine.result.best_index == theirs.result.best_index
