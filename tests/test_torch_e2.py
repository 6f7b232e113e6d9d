"""The port's e2 helpers and vanilla template held against the JAX
package's, on the CPU.

- categorical Naive Bayes: priors, likelihood tables and floors equal to
  the JAX package's on the same points (the counts are one segment count
  on the device), predictions and scores with and without a default
  likelihood, the ragged and empty refusals;
- the Markov chain: the transition matrix equal to the JAX package's,
  ``predict_top_k`` in the same order with ties in state order, the
  46,340-state limit and the out-of-range refusal with the JAX messages;
- ``ExternalAlgorithm``: a Python child trained, saved, loaded and served
  by both packages with the same answers, and the same refusals;
- the vanilla template trained, deployed and queried by both packages on
  one home, each serving either's instance alike.
"""

import math
import os
import stat
import sys
import textwrap

import numpy as np
import pytest
import torch

from predictionio_tpu import e2 as jax_e2
from predictionio_tpu.controller.base import WorkflowContext as JaxWorkflowContext
from predictionio_tpu.core.workflow import prepare_deploy as jax_prepare_deploy
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch import e2 as port_e2
from predictionio_tpu_torch.controller.base import WorkflowContext
from predictionio_tpu_torch.core.workflow import (
    JAX_VANILLA_FACTORY,
    VANILLA_FACTORY,
    prepare_deploy,
    run_train,
)
from predictionio_tpu_torch.e2.markov import MAX_STATES, transition_counts
from predictionio_tpu_torch.e2.naivebayes import count_tables
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig


def _points(seed=0, n=400, sizes=(3, 7, 20), n_labels=4):
    rng = np.random.default_rng(seed)
    return [(f"l{rng.integers(0, n_labels)}",
             [f"v{rng.integers(0, k)}" for k in sizes]) for _ in range(n)]


def _nb(pkg, pts, smoothing=1.0):
    if pkg == "jax":
        return jax_e2.categorical_naive_bayes_train(
            [jax_e2.LabeledPoint(lab, f) for lab, f in pts], smoothing)
    return port_e2.categorical_naive_bayes_train(
        [port_e2.LabeledPoint(lab, f) for lab, f in pts], smoothing, device="cpu")


# -- categorical naive Bayes -------------------------------------------------------


@pytest.mark.parametrize("seed,smoothing", [(0, 1.0), (1, 0.5), (2, 2.0)])
def test_categorical_naive_bayes_equals_the_jax_package(seed, smoothing):
    pts = _points(seed)
    theirs, mine = _nb("jax", pts, smoothing), _nb("port", pts, smoothing)
    assert mine.priors == theirs.priors
    assert mine.likelihoods == theirs.likelihoods
    assert mine.min_log_likelihood == theirs.min_log_likelihood
    rng = np.random.default_rng(seed + 10)
    for _ in range(30):
        feats = [f"v{rng.integers(0, k + 2)}" for k in (3, 7, 20)]  # some unseen
        assert mine.predict(feats) == theirs.predict(feats)
        for lab in list(theirs.priors) + ["nope"]:
            pm = port_e2.LabeledPoint(lab, feats)
            pj = jax_e2.LabeledPoint(lab, feats)
            assert mine.log_score(pm) == theirs.log_score(pj)
            assert (mine.log_score(pm, default_likelihood=lambda ll: min(ll) - 1.0)
                    == theirs.log_score(pj, default_likelihood=lambda ll: min(ll) - 1.0))


def test_categorical_counts_equal_numpy():
    rng = np.random.default_rng(3)
    sizes = [2, 5, 1000]
    y = rng.integers(0, 6, 5000)
    xs = [rng.integers(0, v, 5000) for v in sizes]
    labels, mats = count_tables(y, xs, 6, sizes, device="cpu")
    np.testing.assert_array_equal(labels, np.bincount(y, minlength=6))
    for x, v, m in zip(xs, sizes, mats):
        np.testing.assert_array_equal(
            m, np.bincount(y * v + x, minlength=6 * v).reshape(6, v))


def test_categorical_naive_bayes_refusals_match():
    for pkg, mod in (("jax", jax_e2), ("port", port_e2)):
        with pytest.raises(ValueError, match="same number of features"):
            _nb(pkg, [("a", ["x"]), ("b", ["x", "y"])])
        with pytest.raises(ValueError, match="no training points"):
            _nb(pkg, [])


def test_categorical_counts_need_a_card_or_a_cpu_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_e2.categorical_naive_bayes_train([port_e2.LabeledPoint("a", ["x"])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_e2.markov_chain_train([(0, 1)], 2)


# -- the Markov chain --------------------------------------------------------------


@pytest.mark.parametrize("n_states,n_pairs,seed", [(30, 2000, 0), (7, 15, 1), (200, 5000, 2)])
def test_markov_chain_equals_the_jax_package(n_states, n_pairs, seed):
    rng = np.random.default_rng(seed)
    # skewed targets, so rows hold ties and empty rows occur
    pairs = np.stack([rng.integers(0, n_states, n_pairs),
                      rng.zipf(1.6, n_pairs) % n_states], 1)
    theirs = jax_e2.markov_chain_train(pairs, n_states)
    mine = port_e2.markov_chain_train(pairs, n_states, device="cpu")
    assert mine.transitions.dtype == np.float32
    np.testing.assert_allclose(mine.transitions, theirs.transitions, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        transition_counts(pairs, n_states, device="cpu").numpy(),
        np.bincount(pairs[:, 0] * n_states + pairs[:, 1],
                    minlength=n_states * n_states).reshape(n_states, n_states))
    for s in range(n_states):
        for k in (1, 3, n_states):
            assert mine.predict_top_k(s, k) == theirs.predict_top_k(s, k)
        assert mine.transition_prob(s, 0) == theirs.transition_prob(s, 0)


def test_markov_chain_examples():
    m = port_e2.markov_chain_train([(0, 1), (0, 1), (0, 2), (1, 0)], 3, device="cpu")
    assert math.isclose(m.transition_prob(0, 1), 2 / 3, rel_tol=1e-6)
    assert m.transition_prob(1, 0) == 1.0 and m.transitions[2].sum() == 0.0
    m = port_e2.markov_chain_train([(0, 1)] * 2 + [(0, 2)] + [(0, 3)] * 3, 4, device="cpu")
    assert [s for s, _ in m.predict_top_k(0, 2)] == [3, 1]
    assert port_e2.markov_chain_train([(0, 1)], 5, device="cpu").predict_top_k(0, 5) == [(1, 1.0)]


@pytest.mark.parametrize("pairs,n_states", [([(0, 7)], 3), ([(-1, 0)], 3),
                                            ([(0, 0)], MAX_STATES + 1), ([(0, 0)], 0)])
def test_markov_chain_refusals_match(pairs, n_states):
    with pytest.raises(ValueError) as theirs:
        jax_e2.markov_chain_train(pairs, n_states)
    with pytest.raises(ValueError) as mine:
        port_e2.markov_chain_train(pairs, n_states, device="cpu")
    assert str(mine.value) == str(theirs.value)
    assert MAX_STATES == 46_340


# -- the external bridge -------------------------------------------------------------

TRAINER = textwrap.dedent("""\
    #!%PY%
    import json, os, sys
    mode = sys.argv[1]
    if mode == "train":
        data = [json.loads(l) for l in open(sys.argv[2])]
        mean = sum(r["x"] for r in data) / len(data)
        json.dump({"mean": mean}, open(os.path.join(sys.argv[3], "m.json"), "w"))
    else:
        model = json.load(open(os.path.join(sys.argv[2], "m.json")))
        for line in sys.stdin:
            q = json.loads(line)
            print(json.dumps({"y": q["x"] - model["mean"]}), flush=True)
""")


@pytest.fixture()
def script(tmp_path):
    path = tmp_path / "engine.py"
    path.write_text(TRAINER.replace("%PY%", sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_external_algorithm_serves_as_the_jax_packages(script, tmp_path):
    answers = {}
    for name, mod, ctx in (
            ("jax", jax_e2, JaxWorkflowContext(storage=JaxStorage(JaxStorageConfig(
                home=str(tmp_path / "jh"))))),
            ("port", port_e2, WorkflowContext(storage=Storage(StorageConfig(
                home=str(tmp_path / "ph")))))):
        algo = mod.ExternalAlgorithm({"command": [sys.executable, script]})
        try:
            model_dir = algo.train(ctx, [{"x": 1.0}, {"x": 3.0}, {"x": 8.0}])
            inst = str(tmp_path / f"instance_{name}")
            os.makedirs(inst)
            assert algo.save_model(model_dir, inst) is None
            assert not os.path.exists(os.path.dirname(model_dir))  # workdir removed
            loaded = algo.load_model(None, inst)
            answers[name] = [algo.predict(loaded, {"x": x}) for x in (10.0, 2.0, -4.0)]
            child = algo._child
            assert algo.predict(loaded, {"x": 0.0}) == {"y": -4.0}
            assert algo._child is child  # the resident child is reused
        finally:
            algo.close()
        assert algo._child is None
    assert answers["port"] == answers["jax"] == [{"y": 6.0}, {"y": -2.0}, {"y": -8.0}]


def test_external_algorithm_refusals_match(script, tmp_path):
    for mod in (jax_e2, port_e2):
        with pytest.raises(ValueError, match="needs params"):
            mod.ExternalAlgorithm({})
        algo = mod.ExternalAlgorithm({"command": [sys.executable, script]})
        with pytest.raises(FileNotFoundError, match="external model dir missing"):
            algo.load_model(None, str(tmp_path))
        with pytest.raises(ValueError, match="requires an instance dir"):
            algo.save_model(str(tmp_path), None)
        failing = mod.ExternalAlgorithm({"command": [sys.executable, "-c",
                                                     "import sys; sys.exit(3)"]})
        with pytest.raises(RuntimeError, match="rc=3"):
            failing.train(None, [{"x": 1}])


# -- the vanilla template -------------------------------------------------------------


def test_vanilla_template_answers_alike_in_both_packages(tmp_path):
    home = str(tmp_path)
    js = JaxStorage(JaxStorageConfig(home=home))
    app = js.meta.create_app("VanillaApp")
    js.events.init_channel(app.id)
    js.events.insert_batch([JaxEvent(event="view", entity_type="user", entity_id=f"u{i}",
                                     target_entity_type="item", target_entity_id=f"i{i % 3}")
                            for i in range(17)], app.id)
    variant = {"id": "default", "datasource": {"params": {"appName": "VanillaApp"}},
               "algorithms": [{"name": "algo", "params": {"mult": 3}}]}
    ji = jax_run_train(JAX_VANILLA_FACTORY, variant=dict(variant, engineFactory=JAX_VANILLA_FACTORY),
                       storage=js, use_mesh=False)
    ps = Storage(StorageConfig(home=home))
    pi = run_train(VANILLA_FACTORY, variant=dict(variant, engineFactory=VANILLA_FACTORY),
                   storage=ps, device="cpu")
    assert ps.meta.get_engine_instance(pi).engine_factory == JAX_VANILLA_FACTORY
    q = {"anything": [1, "two"]}
    for iid in (ji, pi):
        theirs = jax_prepare_deploy(instance_id=iid, storage=js).query(q)
        mine = prepare_deploy(instance_id=iid, storage=ps, device="cpu").query(q)
        assert mine == theirs == {"query": q, "eventCount": 51}
