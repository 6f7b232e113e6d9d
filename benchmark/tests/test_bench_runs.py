"""Whole runs of the cells on the CPU at tiny sizes: the last line's
schema, the traced run's fields, and a run in a process that must load
neither JAX nor the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import run
from benchlib import common

BENCH = str(common.BENCH)


@pytest.fixture(scope="module", autouse=True)
def _env():
    common.prepare_environment()


def _line(fields, checks):
    return json.loads(common.result_line(fields["correct"], fields["attempted"],
                                         fields["failed"], fields["metrics"], fields["device"],
                                         checks, fields["breakdown"]))


def test_train_cell_last_line(als_spec):
    fields, checks = run.run_cell("train.rec-als-ml20m", 2**31 + 11, 0.5, False,
                                  device="cpu", spec=als_spec)
    doc = _line(fields, checks)
    assert list(doc) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert doc["correct"] is True and doc["attempted"] >= 1 and doc["failed"] == 0
    assert set(doc["metrics"]) == {"train_ratings_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in doc["metrics"].values())
    assert set(doc["checks"]) == {"objective_gap", "v_normal_eq"}
    assert all(c["value"] <= c["limit"] for c in doc["checks"].values())


def test_batch_cell_traced_line(batch_spec):
    fields, checks = run.run_cell("batch.twotower-ann-10m", 7, 0.5, True,
                                  device="cpu", spec=batch_spec)
    doc = _line(fields, checks)
    assert list(doc)[-1] == "checks" and "breakdown" in doc
    assert set(doc["breakdown"]) == {"device_ops", "idle_gaps"}
    assert doc["device"]["window_s"] > 0
    # no device ran: the readers of device shares find nothing, the host
    # clock's readers do
    assert set(doc["metrics"]) == {"ann_build_s"}
    assert doc["correct"] is True


def test_same_seed_same_inputs():
    import numpy as np

    from benchlib import traffic

    cfg = {"num_users": 50, "num_items": 20, "num_ratings": 500,
           "ratings": {"draws_seed": 7, "user_min": 5, "user_max": 20, "item_min": 1,
                       "item_max": 60}}
    a, b, c = traffic.ratings(cfg, 5), traffic.ratings(cfg, 5), traffic.ratings(cfg, 6)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    # every seed has the same counts, relabelled
    assert sorted(np.bincount(a[0], minlength=50)) == sorted(np.bincount(c[0], minlength=50))


def test_ratings_follow_the_law():
    """Every user's count is the law's (at least its minimum, the largest
    its maximum), the total is exact, and no (user, item) pair repeats."""
    import numpy as np

    from benchlib import traffic

    law = traffic.count_law(300, 20, 150, 12000)
    assert law.sum() == 12000 and law.max() == 150 and law.min() == 20
    assert (np.diff(law[1:]) <= 0).all()
    users, items = traffic.law_ratings(12000, 300, 160, 3, 20, 150, 1, 500)
    assert (np.bincount(users, minlength=300) == law).all()
    assert len(set(zip(users.tolist(), items.tolist()))) == 12000
    assert np.bincount(items, minlength=160).max() <= 500 + 300


SCRIPT = r"""
import sys
sys.path.insert(0, {bench!r})
from benchlib import common
common.prepare_environment()
import run, control
from benchlib import drive_als, drive_ann, tracing, readers, work, traffic
from reference import als, twotower
import torch
run.run_cell("train.rec-als-ml20m", 3, 0.2, True, device="cpu", spec={spec})
bad = sorted({{n.split(".")[0] for n in sys.modules}} & {{"jax", "jaxlib", "flax", "predictionio_tpu"}})
assert common.forbidden_loaded() == bad
print("LOADED", bad)
"""


def test_no_jax_in_a_run(als_spec):
    code = SCRIPT.format(bench=BENCH, spec=repr(als_spec))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(common.ROOT),
                         env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "predictionio_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert "predictionio_tpu" not in common.forbidden_loaded()
    assert "jax" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in common.forbidden_loaded()


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing
    on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "train.rec-als-ml20m", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(common.ROOT))
    assert out.returncode != 0 and out.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    the command exits non-zero and prints nothing on standard output."""
    import shutil

    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv = ['run.py', '--workload', 'train.rec-als-ml20m', "
            "'--seed', '1', '--seconds', '1']; sys.path.insert(0, 'benchmark'); "
            "from benchlib import common; common.prepare_environment(); import run; "
            "run.run_cell('train.rec-als-ml20m', 1, 0.1, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
    assert "predictionio_tpu_torch" in out.stderr
