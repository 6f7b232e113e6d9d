"""Mid-train checkpoints and ``pio train --resume`` in the port, on the CPU.

The port's ``utils/checkpoint.TrainCheckpointer`` keeps the JAX package's
API and recovery semantics on its own format (a directory per step with
an ``.npz`` and its sha256 sidecar; the JAX one is Orbax). The cases of
``tests/test_checkpoint.py`` that do not depend on the format run on
both packages' checkpointers; the torn, transient and permuted cases run
on the port's format:

- a torn or truncated newest step falls back to the previous one and is
  pruned, so the resumed run's save at that step lands;
- a transiently unreadable step is neither pruned nor wiped, and the
  error propagates;
- shapes that match positionally only when permuted are rejected, and
  only when every step mismatches is ``CheckpointGeometryError`` raised.

Checkpointed ALS (``als_train_prepared(checkpointer=, checkpoint_every=)``)
resumed after a cut equals the straight run bitwise on the CPU and the
JAX package's straight run within 1e-4; a run that died after its final
save recovers without training; a stale checkpoint is wiped with a
RuntimeWarning. ``run_train(resume=True)`` continues a train cut after
its second checkpoint, the completed run removes its checkpoints, a
fresh run clears them, the checkpoints live under ``train_ckpt_torch/``
(which the JAX ``run_train`` on the same home leaves alone), and the CLI
takes ``train --resume``.
"""

import os

import numpy as np
import pytest

import predictionio_tpu.models.als as jax_als
import predictionio_tpu_torch.models.als as port_als
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.utils import checkpoint as jax_ckpt
from predictionio_tpu_torch.core import workflow
from predictionio_tpu_torch.core.workflow import (
    RECOMMENDATION_FACTORY,
    prepare_deploy,
    run_train,
)
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_workflow import FACTORY as JAX_FACTORY
from tests.test_workflow import seed_ratings

PACKAGES = {"jax": jax_ckpt, "port": port_ckpt}
TOL = 1e-4


@pytest.fixture(params=["jax", "port"])
def ckmod(request):
    return PACKAGES[request.param]


def _torn(d, step):
    """Truncate every file under a step (structure intact, bytes gone)."""
    for root, _dirs, files in os.walk(os.path.join(d, str(step))):
        for f in files:
            open(os.path.join(root, f), "wb").close()


# -- the checkpointer ---------------------------------------------------------


def test_round_trip_and_latest(tmp_path, ckmod):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "opt": {"mu": np.zeros(3), "count": np.asarray(4)}}
    with ckmod.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        assert ck.latest_step() is None
        ck.save(1, state)
        state2 = {**state, "w": state["w"] * 2}
        ck.save(2, state2)
        assert ck.latest_step() == 2
        got = ck.restore(template=state)
        np.testing.assert_array_equal(got["w"], state2["w"])
        np.testing.assert_array_equal(got["opt"]["count"], 4)
        got1 = ck.restore(step=1, template=state)
        np.testing.assert_array_equal(got1["w"], state["w"])


def test_keep_policy(tmp_path, ckmod):
    with ckmod.TrainCheckpointer(str(tmp_path / "ck"), keep=2) as ck:
        for s in (1, 2, 3, 4):
            ck.save(s, {"x": np.asarray([s])})
        assert ck.latest_step() == 4
        with pytest.raises(Exception):
            ck.restore(step=1, template={"x": np.asarray([0])})
        np.testing.assert_array_equal(ck.restore(step=3, template={"x": np.asarray([0])})["x"],
                                      [3])


def test_restore_empty_raises(tmp_path, ckmod):
    with ckmod.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore()


def test_picks_newest_matching(tmp_path, ckmod):
    with ckmod.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(1, {"x": np.asarray([1.0], np.float32)})
        ck.save(2, {"x": np.asarray([2.0], np.float32)})
        state, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 2
        np.testing.assert_array_equal(state["x"], [2.0])


def test_all_mismatched_raises_geometry_error(tmp_path, ckmod):
    with ckmod.TrainCheckpointer(str(tmp_path / "ck")) as ck:
        ck.save(1, {"x": np.zeros((3, 3), np.float32)})
        ck.save(2, {"x": np.zeros((3, 3), np.float32)})
        with pytest.raises(ckmod.CheckpointGeometryError):
            ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})


def test_permuted_shapes_rejected_positionally(tmp_path, ckmod):
    d = str(tmp_path / "ck")
    with ckmod.TrainCheckpointer(d) as ck:
        ck.save(1, {"a": np.zeros((128, 4), np.float32),
                    "b": np.zeros((64, 4), np.float32)})
    with ckmod.TrainCheckpointer(d) as ck:
        with pytest.raises(ckmod.CheckpointGeometryError):
            ck.restore_latest_compatible({"a": np.zeros((64, 4), np.float32),
                                          "b": np.zeros((128, 4), np.float32)})


def test_permuted_newer_step_pruned_after_fallback(tmp_path, ckmod):
    d = str(tmp_path / "ck")
    good = {"a": np.ones((4, 2), np.float32), "b": np.ones((8, 2), np.float32)}
    swapped = {"a": np.ones((8, 2), np.float32), "b": np.ones((4, 2), np.float32)}
    with ckmod.TrainCheckpointer(d) as ck:
        ck.save(1, good)
        ck.save(2, swapped)  # stale geometry, same shape multiset
    with ckmod.TrainCheckpointer(d) as ck:
        state, step = ck.restore_latest_compatible(good)
        assert step == 1
        ck.save(2, {"a": good["a"] * 2, "b": good["b"]})  # must land
    with ckmod.TrainCheckpointer(d) as ck:
        state, step = ck.restore_latest_compatible(good)
        assert step == 2
        np.testing.assert_array_equal(state["a"], good["a"] * 2)


def test_truncated_newest_falls_back_and_is_pruned(tmp_path, ckmod):
    d = str(tmp_path / "ck")
    with ckmod.TrainCheckpointer(d) as ck:
        ck.save(1, {"x": np.asarray([1.0], np.float32)})
        ck.save(2, {"x": np.asarray([2.0], np.float32)})
    _torn(d, 2)
    with ckmod.TrainCheckpointer(d) as ck:
        state, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 1
        np.testing.assert_array_equal(state["x"], [1.0])
        # the resumed run re-reaches step 2: the save must land
        ck.save(2, {"x": np.asarray([22.0], np.float32)})
    with ckmod.TrainCheckpointer(d) as ck:
        state, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 2
        np.testing.assert_array_equal(state["x"], [22.0])


def test_a_corrupted_payload_is_torn_not_stale(tmp_path):
    """The port's digest: flipped bytes under an intact sidecar read as a
    torn step (pruned after a fallback), never as valid state."""
    d = str(tmp_path / "ck")
    with port_ckpt.TrainCheckpointer(d) as ck:
        ck.save(1, {"x": np.asarray([1.0], np.float32)})
        ck.save(2, {"x": np.asarray([2.0], np.float32)})
    path = os.path.join(d, "2", port_ckpt.PAYLOAD)
    data = bytearray(open(path, "rb").read())
    data[-9] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with port_ckpt.TrainCheckpointer(d) as ck:
        with pytest.raises(port_ckpt.TornCheckpointError):
            ck.restore(step=2)
        _, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 1 and ck.all_steps() == [1]


def test_only_torn_steps_propagate_the_read_error(tmp_path):
    d = str(tmp_path / "ck")
    with port_ckpt.TrainCheckpointer(d) as ck:
        ck.save(1, {"x": np.asarray([1.0], np.float32)})
    _torn(d, 1)
    with port_ckpt.TrainCheckpointer(d) as ck:
        with pytest.raises(port_ckpt.TornCheckpointError):
            ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})


def test_transiently_unreadable_newer_step_not_pruned(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    with port_ckpt.TrainCheckpointer(d) as ck:
        ck.save(1, {"x": np.asarray([1.0], np.float32)})
        ck.save(2, {"x": np.asarray([2.0], np.float32)})
    orig = port_ckpt.TrainCheckpointer._read_flat

    def flaky(self, step):
        if step == 2:
            raise OSError("NFS hiccup")
        return orig(self, step)

    monkeypatch.setattr(port_ckpt.TrainCheckpointer, "_read_flat", flaky)
    with port_ckpt.TrainCheckpointer(d) as ck:
        _, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 1  # fell back past the flaky step
    monkeypatch.undo()
    with port_ckpt.TrainCheckpointer(d) as ck:
        state, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 2
        np.testing.assert_array_equal(state["x"], [2.0])
        # a save colliding with a kept step refuses loudly
        with pytest.raises(RuntimeError, match="already present"):
            ck.save(2, {"x": np.asarray([3.0], np.float32)})


def test_transient_error_propagates_and_preserves_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    with port_ckpt.TrainCheckpointer(d) as ck:
        ck.save(1, {"x": np.asarray([1.0], np.float32)})
    with port_ckpt.TrainCheckpointer(d) as ck:
        monkeypatch.setattr(port_ckpt.TrainCheckpointer, "_read_flat",
                            lambda self, *a, **k: (_ for _ in ()).throw(
                                OSError("disk glitch")))
        with pytest.raises(OSError, match="disk glitch"):
            ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
    monkeypatch.undo()
    with port_ckpt.TrainCheckpointer(d) as ck:
        _, step = ck.restore_latest_compatible({"x": np.zeros(1, np.float32)})
        assert step == 1


def test_each_step_is_read_once_on_resume(tmp_path, monkeypatch):
    """restore_latest_compatible reads and digest-checks a step once:
    the stale newest step and the matching one below it, one read each,
    and the state comes back in the template's dtypes."""
    d = str(tmp_path / "ck")
    with port_ckpt.TrainCheckpointer(d) as ck:
        ck.save(1, {"x": np.asarray([1.0, 2.0], np.float32)})
        ck.save(2, {"x": np.zeros(3, np.float32)})  # stale geometry
    reads = []
    orig = port_ckpt.TrainCheckpointer._read_flat

    def counted(self, step):
        reads.append(step)
        return orig(self, step)

    monkeypatch.setattr(port_ckpt.TrainCheckpointer, "_read_flat", counted)
    with port_ckpt.TrainCheckpointer(d) as ck:
        state, step = ck.restore_latest_compatible({"x": np.zeros(2, np.float64)})
    assert (step, reads) == (1, [2, 1])
    assert state["x"].dtype == np.float64
    np.testing.assert_array_equal(state["x"], [1.0, 2.0])


def test_clear_and_a_half_written_step_is_invisible(tmp_path):
    d = str(tmp_path / "ck")
    with port_ckpt.TrainCheckpointer(d) as ck:
        ck.save(3, {"x": np.asarray([1.0], np.float32)})
        os.makedirs(os.path.join(d, ".tmp-4-123"))  # a save cut before its rename
        assert ck.all_steps() == [3]
        ck.clear()
        assert ck.latest_step() is None and os.path.isdir(d)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".pio-")]


# -- checkpointed ALS ------------------------------------------------------------


def _coo(mod):
    rng = np.random.default_rng(5)
    n_u, n_i, nnz = 40, 25, 400
    return mod.RatingsCOO(rng.integers(0, n_u, nnz).astype(np.int32),
                          rng.integers(0, n_i, nnz).astype(np.int32),
                          rng.uniform(1, 5, nnz).astype(np.float32), n_u, n_i)


@pytest.mark.parametrize("implicit", [False, True])
def test_als_resume_equals_the_straight_run(tmp_path, implicit):
    prep = port_als.als_prepare(_coo(port_als))
    p8 = port_als.ALSParams(rank=4, iterations=8, reg=0.1, seed=2, implicit=implicit)
    U_ref, V_ref = port_als.als_train_prepared(prep, p8, device="cpu")
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        port_als.als_train_prepared(prep, port_als.ALSParams(
            rank=4, iterations=4, reg=0.1, seed=2, implicit=implicit), device="cpu",
            checkpointer=ck, checkpoint_every=2)
        assert ck.all_steps() == [2, 4]
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        U, V = port_als.als_train_prepared(prep, p8, device="cpu", checkpointer=ck,
                                           checkpoint_every=2)
        assert ck.all_steps() == [4, 6, 8]
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_array_equal(V, V_ref)
    jp = jax_als.ALSParams(rank=4, iterations=8, reg=0.1, seed=2, implicit=implicit)
    Uj, Vj = jax_als.als_train_prepared(jax_als.als_prepare(_coo(jax_als)), jp)
    np.testing.assert_allclose(U, Uj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(V, Vj, rtol=TOL, atol=TOL)


def test_als_resume_after_the_final_save_does_not_train(tmp_path, monkeypatch):
    prep = port_als.als_prepare(_coo(port_als))
    p = port_als.ALSParams(rank=4, iterations=4, reg=0.1, seed=2)
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        U_ref, V_ref = port_als.als_train_prepared(prep, p, device="cpu", checkpointer=ck,
                                                   checkpoint_every=3)
        assert ck.all_steps() == [3, 4]
    calls = {"n": 0}
    orig = port_als._train_permuted

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(port_als, "_train_permuted", counting)
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        U, V = port_als.als_train_prepared(prep, p, device="cpu", checkpointer=ck,
                                           checkpoint_every=3)
    assert calls["n"] == 0, "a fully checkpointed run must not train again"
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_array_equal(V, V_ref)


def test_als_stale_checkpoint_is_wiped_and_training_starts_over(tmp_path):
    prep = port_als.als_prepare(_coo(port_als))
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        ck.save(3, {"U": np.zeros((5, 3), np.float32), "V": np.zeros((7, 9), np.float32)})
    p = port_als.ALSParams(rank=4, iterations=3, reg=0.1, seed=2)
    U_ref, V_ref = port_als.als_train_prepared(prep, p, device="cpu")
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        with pytest.warns(RuntimeWarning, match="stale"):
            U, V = port_als.als_train_prepared(prep, p, device="cpu", checkpointer=ck,
                                               checkpoint_every=2)
        assert ck.all_steps() == [2, 3]
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_array_equal(V, V_ref)


def test_als_with_no_iterations_takes_the_unblocked_path(tmp_path):
    prep = port_als.als_prepare(_coo(port_als))
    p = port_als.ALSParams(rank=4, iterations=3, reg=0.1, seed=2)
    _, V = port_als.als_train_prepared(prep, p, device="cpu")
    U_ref, _ = port_als.als_train_prepared(
        prep, port_als.ALSParams(rank=4, iterations=0, reg=0.1, seed=2), device="cpu", V0=V)
    with port_ckpt.TrainCheckpointer(str(tmp_path / "als")) as ck:
        U, V0 = port_als.als_train_prepared(
            prep, port_als.ALSParams(rank=4, iterations=0, reg=0.1, seed=2), device="cpu",
            V0=V, checkpointer=ck, checkpoint_every=2)
        assert ck.latest_step() is None
    np.testing.assert_array_equal(U, U_ref)
    np.testing.assert_array_equal(V0, V)


# -- run_train --resume -----------------------------------------------------------


def _variant(every=2, iterations=6):
    return {"id": "ckpt", "engineFactory": RECOMMENDATION_FACTORY,
            "datasource": {"params": {"appName": "TestApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "numIterations": iterations, "lambda": 0.05,
                "checkpointEvery": every}}]}


def _home(tmp_path):
    home = str(tmp_path / "home")
    seed_ratings(JaxStorage(JaxStorageConfig(home=home)))
    return home, Storage(StorageConfig(home=home))


def test_run_train_resumes_a_train_cut_after_its_second_checkpoint(tmp_path, monkeypatch):
    home, storage = _home(tmp_path)
    ref_id = run_train(RECOMMENDATION_FACTORY, variant=_variant(), storage=storage,
                       device="cpu")
    ref = prepare_deploy(instance_id=ref_id, storage=storage, device="cpu").models[0]
    orig_save = port_ckpt.TrainCheckpointer.save
    saves = []

    def cut_save(self, step, state):
        orig_save(self, step, state)
        saves.append(step)
        if len(saves) == 2:
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(port_ckpt.TrainCheckpointer, "save", cut_save)
    with pytest.raises(RuntimeError, match="preemption"):
        run_train(RECOMMENDATION_FACTORY, variant=_variant(), storage=storage, device="cpu")
    statuses = [ei.status for ei in JaxStorage(JaxStorageConfig(
        home=home)).meta.list_engine_instances()]
    assert sorted(statuses) == ["COMPLETED", "FAILED"]
    root = workflow._ckpt_root(storage, RECOMMENDATION_FACTORY, "ckpt")
    assert root.startswith(os.path.join(home, "train_ckpt_torch"))
    assert port_ckpt.TrainCheckpointer(os.path.join(root, "als")).latest_step() == 4

    saves.clear()

    def counting_save(self, step, state):
        orig_save(self, step, state)
        saves.append(step)

    monkeypatch.setattr(port_ckpt.TrainCheckpointer, "save", counting_save)
    iid = run_train(RECOMMENDATION_FACTORY, variant=_variant(), storage=storage,
                    device="cpu", resume=True)
    assert saves == [6], "resume must continue, not retrain"
    got = prepare_deploy(instance_id=iid, storage=storage, device="cpu").models[0]
    np.testing.assert_array_equal(got.U, ref.U)
    np.testing.assert_array_equal(got.V, ref.V)
    assert not os.path.exists(root)  # a completed run removes its checkpoints


def test_a_fresh_run_clears_the_checkpoints_and_resume_keeps_them(tmp_path):
    home, storage = _home(tmp_path)
    root = workflow._ckpt_root(storage, RECOMMENDATION_FACTORY, "ckpt")
    with port_ckpt.TrainCheckpointer(os.path.join(root, "als")) as ck:
        ck.save(2, {"U": np.zeros((5, 3), np.float32), "V": np.zeros((7, 9), np.float32)})
    # resume keeps them: the stale geometry is found and wiped with a warning
    with pytest.warns(RuntimeWarning, match="stale"):
        run_train(RECOMMENDATION_FACTORY, variant=_variant(), storage=storage,
                  device="cpu", resume=True)
    with port_ckpt.TrainCheckpointer(os.path.join(root, "als")) as ck:
        ck.save(2, {"U": np.zeros((5, 3), np.float32), "V": np.zeros((7, 9), np.float32)})
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a fresh run never sees them
        run_train(RECOMMENDATION_FACTORY, variant=_variant(), storage=storage, device="cpu")
    assert not os.path.exists(root)


def test_the_jax_run_train_leaves_the_ports_checkpoints_alone(tmp_path):
    home, storage = _home(tmp_path)
    root = workflow._ckpt_root(storage, JAX_FACTORY, "ckpt")
    assert root == workflow._ckpt_root(storage, RECOMMENDATION_FACTORY, "ckpt")
    with port_ckpt.TrainCheckpointer(os.path.join(root, "als")) as ck:
        ck.save(2, {"U": np.ones((30, 4), np.float32), "V": np.ones((20, 4), np.float32)})
    jax_variant = dict(_variant(), engineFactory=JAX_FACTORY)
    jax_run_train(JAX_FACTORY, variant=jax_variant, storage=JaxStorage(JaxStorageConfig(
        home=home)), use_mesh=False)
    assert port_ckpt.TrainCheckpointer(os.path.join(root, "als")).all_steps() == [2]
    assert not os.path.exists(os.path.join(home, "train_ckpt", "train_ckpt_torch"))


def test_recommendation_template_checkpoints_only_under_a_checkpoint_dir(tmp_path):
    from predictionio_tpu_torch.controller import WorkflowContext

    assert WorkflowContext(device="cpu").checkpointer("als") is None
    ck = WorkflowContext(device="cpu", checkpoint_dir=str(tmp_path)).checkpointer("als")
    assert isinstance(ck, port_ckpt.TrainCheckpointer)
    assert ck.directory == os.path.join(str(tmp_path), "als")


def test_cli_train_takes_resume():
    args = cli.build_parser().parse_args(["train", "--engine-dir", ".", "--resume",
                                          "--device", "cpu"])
    assert args.resume is True and args.device == "cpu"
    assert cli.build_parser().parse_args(["train"]).resume is False
    help_text = cli.build_parser()._subparsers._group_actions[0].choices["train"].format_help()
    assert "train_ckpt_torch" in help_text and "Orbax" in help_text
