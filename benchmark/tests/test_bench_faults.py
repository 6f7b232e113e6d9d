"""A run with the timed path broken underneath must come out not
correct: each fault the cell can have (``benchlib/faults.py``), planted
in the program on the CPU at a tiny size (the run's look for a card
skipped)."""

from __future__ import annotations

import pytest

import run
from benchlib import common, faults


@pytest.fixture(scope="module", autouse=True)
def _env():
    common.prepare_environment()


def _correct(workload, spec):
    fields, checks = run.run_cell(workload, 2**31 + 5, 0.5, False, device="cpu", spec=spec)
    return fields["correct"], checks


def test_train_sound_run_is_correct(als_spec):
    assert _correct("train.rec-als-ml20m", als_spec)[0]


def test_batch_sound_run_is_correct(batch_spec):
    assert _correct("batch.twotower-ann-10m", batch_spec)[0]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["als_train_loop"]))
def test_train_fault_refused(als_spec, fault):
    with faults.FAULTS["als_train_loop"][fault]():
        ok, checks = _correct("train.rec-als-ml20m", als_spec)
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["batchpredict"]))
def test_batch_fault_refused(batch_spec, fault):
    with faults.FAULTS["batchpredict"][fault]():
        ok, checks = _correct("batch.twotower-ann-10m", batch_spec)
    assert not ok, checks
