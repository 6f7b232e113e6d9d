"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``card`` that need the CUDA card and skip without one (the decision is
made inside the test, never at import)."""

from __future__ import annotations

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")


def _load(rel):
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


def tiny_als():
    cfg = _load("configs/rec-als-ml20m.json")
    cfg.update(num_users=1500, num_items=400, num_ratings=30000, rank=8, iterations=3)
    cfg["ratings"].update(user_min=5, user_max=300, item_max=1500)
    return ({"name": "train.rec-als-ml20m", "chips": 1}, cfg,
            _load("traffic/als-train-back-to-back.json"))


def tiny_ann(mix_name, **mix_over):
    cfg = _load("configs/twotower-ann-10m.json")
    cfg.update(num_users=3000, num_items=12000, check_answers=12, check_codes=1500)
    cfg["algorithm"].update(hidden=[16], annK=16, annSample=2048, annShortlist=32)
    mix = _load(f"traffic/{mix_name}.json")
    mix.update(mix_over)
    return cfg, mix


@pytest.fixture
def als_spec():
    return tiny_als()


@pytest.fixture
def batch_spec():
    cfg, mix = tiny_ann("batchpredict-1024-uniform", batch=32)
    return ({"name": "batch.twotower-ann-10m", "chips": 1}, cfg, mix)


@pytest.fixture
def needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
