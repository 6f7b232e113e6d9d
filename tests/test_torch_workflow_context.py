"""The port's ``WorkflowContext`` flags (``batch``, ``skip_sanity_check``,
``stop_after_read``, ``stop_after_prepare``) held against the JAX
package's: both packages' ``Engine.train``, ``Engine.eval`` and sweep
run the toy engine of tests/test_sweep.py (and its port twin in
tests/test_torch_eval.py) on the same data, stop at the same stage,
fill the same ``timings`` keys and call or skip ``sanity_check`` alike."""

from __future__ import annotations

import dataclasses

import pytest

import tests.test_sweep as jax_toy
import tests.test_torch_eval as port_toy
from predictionio_tpu.controller.base import WorkflowContext as JaxWorkflowContext
from predictionio_tpu.core.sweep import run_sweep as jax_run_sweep
from predictionio_tpu_torch.controller import WorkflowContext
from predictionio_tpu_torch.core.sweep import run_sweep

FLAGS = ("skip_sanity_check", "stop_after_read", "stop_after_prepare")


class Sides:
    """One toy engine a package, its context and a log of the calls the
    algorithm and the preparator took."""

    def __init__(self, monkeypatch, tmp_path):
        self.calls = {"jax": [], "port": []}
        for side, mod in (("jax", jax_toy), ("port", port_toy)):
            log = self.calls[side]
            monkeypatch.setattr(
                mod.ToyAlgo, "sanity_check",
                lambda algo, pd, log=log: log.append(("sanity", algo.params.scale)),
                raising=False)
            orig_train = mod.ToyAlgo.train

            def train(algo, ctx, pd, log=log, orig=orig_train):
                log.append(("train", algo.params.scale))
                return orig(algo, ctx, pd)

            monkeypatch.setattr(mod.ToyAlgo, "train", train)
        self.tmp_path = tmp_path

    def ctx(self, side, **flags):
        if side == "jax":
            return JaxWorkflowContext(storage=port_toy._jax_storage(
                str(self.tmp_path / "jax")), **flags)
        return WorkflowContext(storage=port_toy._port_storage(
            str(self.tmp_path / "port")), device="cpu", **flags)


@pytest.fixture()
def sides(monkeypatch, tmp_path):
    return Sides(monkeypatch, tmp_path)


def _train(sides, **flags):
    out = {}
    for side, mod in (("jax", jax_toy), ("port", port_toy)):
        ctx = sides.ctx(side, **flags)
        models = mod.toy_factory().train(ctx, mod._toy_candidates([2.0])[0])
        out[side] = (models, sorted(ctx.timings), list(sides.calls[side]))
    return out


@pytest.mark.parametrize("flag", (None,) + FLAGS)
def test_train_stops_and_checks_like_the_jax_package(sides, flag):
    out = _train(sides, **({flag: True} if flag else {}))
    assert out["port"] == out["jax"]
    models, timings, calls = out["port"]
    expected = {
        None: ([{"scale": 2.0}], ["prepare", "read_training", "train:toy"],
               [("sanity", 2.0), ("train", 2.0)]),
        "skip_sanity_check": ([{"scale": 2.0}],
                              ["prepare", "read_training", "train:toy"],
                              [("train", 2.0)]),
        "stop_after_read": ([], ["read_training"], []),
        "stop_after_prepare": ([], ["prepare", "read_training"], []),
    }[flag]
    assert (models, timings, calls) == expected


def test_batch_label_rides_along_without_changing_the_train(sides):
    out = _train(sides, batch="nightly")
    assert out["port"] == out["jax"] == (
        [{"scale": 2.0}], ["prepare", "read_training", "train:toy"],
        [("sanity", 2.0), ("train", 2.0)])
    assert sides.ctx("port", batch="nightly").batch == "nightly"


@pytest.mark.parametrize("skip", (False, True))
def test_eval_checks_or_skips_sanity_like_the_jax_package(sides, skip):
    scales = [0.5, 3.0]
    got = {}
    for side, mod in (("jax", jax_toy), ("port", port_toy)):
        ctx = sides.ctx(side, skip_sanity_check=skip)
        eng = mod.toy_factory()
        batches = eng.eval_batch(ctx, mod._toy_candidates(scales))
        preds = [[p["y"] for _, qpa in folds for _, p, _ in qpa] for folds in batches]
        got[side] = (sides.calls[side], preds)
    assert got["port"][0] == got["jax"][0]
    sanity = [c for c in got["port"][0] if c[0] == "sanity"]
    # two folds, each checking every candidate unless skipped
    assert sanity == ([] if skip else [("sanity", 0.5), ("sanity", 3.0)] * 2)
    for mine, theirs in zip(got["port"][1], got["jax"][1]):
        assert mine == pytest.approx(theirs, rel=1e-6)


@pytest.mark.parametrize("skip", (False, True))
def test_sweep_checks_or_skips_sanity_like_the_jax_package(sides, skip):
    scales = [1.0, 3.0]
    mine = run_sweep(sides.ctx("port", skip_sanity_check=skip), port_toy.toy_factory(),
                     port_toy._toy_candidates(scales), port_toy.ToyNegRMSE())
    theirs = jax_run_sweep(sides.ctx("jax", skip_sanity_check=skip),
                           jax_toy.toy_factory(), jax_toy._toy_candidates(scales),
                           jax_toy.ToyNegRMSE())
    assert sides.calls["port"] == sides.calls["jax"]
    assert sides.calls["port"] == ([] if skip else [("sanity", 1.0), ("sanity", 3.0)] * 2)
    assert (mine.vmapped, mine.serial) == (theirs.vmapped, theirs.serial) == (2, 0)
    assert mine.result.best_index == theirs.result.best_index == 1


def test_a_context_built_with_every_jax_field_constructs_in_the_port(tmp_path):
    jax_fields = {f.name: f for f in dataclasses.fields(JaxWorkflowContext)}
    port_fields = {f.name: f for f in dataclasses.fields(WorkflowContext)}
    assert set(jax_fields) <= set(port_fields)
    # the shared plain fields keep the JAX defaults
    for name, f in jax_fields.items():
        if f.default is not dataclasses.MISSING:
            assert port_fields[name].default == f.default, name
    values = {"batch": "b1", "verbose": 1, "skip_sanity_check": True,
              "stop_after_read": True, "stop_after_prepare": True,
              "timings": {"read_training": 0.5}, "instance_id": "i1",
              "checkpoint_dir": str(tmp_path / "ckpt"), "mesh": None,
              "storage": port_toy._port_storage(str(tmp_path))}
    assert set(values) == set(jax_fields)
    jctx = JaxWorkflowContext(**dict(values, storage=port_toy._jax_storage(
        str(tmp_path / "jax"))))
    ctx = WorkflowContext(**values)
    for name in jax_fields:
        if name != "storage":
            assert getattr(ctx, name) == getattr(jctx, name), name
