"""Tests that need the CUDA card (marked ``card``; they skip without
one): the control at a size a test run holds must come out not correct,
and a small run of each cell must be correct.

    python -m pytest benchmark/tests -m card
"""

from __future__ import annotations

import pytest

import run
from benchlib import common
from conftest import tiny_ann, tiny_als


@pytest.fixture(scope="module", autouse=True)
def _env():
    common.prepare_environment()


def _small_als():
    wl, cfg, mix = tiny_als()
    cfg.update(num_users=20000, num_items=4000, num_ratings=1_000_000, rank=64, iterations=4)
    cfg["ratings"].update(user_max=1500, item_max=20000)
    return wl, cfg, mix


def _small_batch():
    cfg, mix = tiny_ann("batchpredict-1024-uniform", batch=256)
    cfg.update(num_users=20000, num_items=400_000)
    cfg["algorithm"].update(hidden=[64], annK=256, annSample=65536, annShortlist=128)
    return {"name": "batch.twotower-ann-10m", "chips": 1}, cfg, mix


@pytest.mark.card
@pytest.mark.parametrize("cell,spec", [("train.rec-als-ml20m", _small_als),
                                       ("batch.twotower-ann-10m", _small_batch)])
def test_program_correct_control_not(needs_card, cell, spec):
    for seed in (11, 12, 13):
        fields, checks = run.run_cell(cell, seed, 1.0, False, spec=spec())
        assert fields["correct"], checks
        fields, checks = run.run_cell(cell, seed, 1.0, False, spec=spec(), control=True)
        assert not fields["correct"], checks
