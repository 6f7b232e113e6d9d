"""The port's device mesh and its one-process distributed shell against
the JAX package's (``parallel/mesh.py``, ``parallel/distributed.py``).

The JAX side builds its meshes over the eight virtual CPU devices that
``tests/conftest.py`` forces; the port gets eight CPU slots by naming the
CPU eight times. Both must clamp, raise and lay out axes alike.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from predictionio_tpu.parallel import distributed as jax_dist
from predictionio_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh
from predictionio_tpu.parallel.mesh import pad_to_multiple as jax_pad
from predictionio_tpu.parallel.mesh import shards_mesh as jax_shards_mesh
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu.parallel.ring_attention import ring_attention as jax_ring
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    make_mesh,
    pad_to_multiple,
    platform_devices,
    process_slots,
    shards_mesh,
)
from predictionio_tpu_torch.parallel.ring_attention import ring_attention

CPU8 = ["cpu"] * 8
JAX8 = jax.devices("cpu")


def _shape(mesh) -> dict:
    return dict(mesh.shape)


@pytest.mark.parametrize("conf", [
    None, {}, {"mesh": {}}, {"mesh": {"data": 8}}, {"mesh": {"data": 4}},
    {"mesh": {"data": 4, "model": 2}}, {"mesh": {"data": 2, "model": 4}},
    {"mesh": {"data": 16}}, {"mesh": {"data": 4, "model": 4}},
    {"mesh": {"data": 3}, "allowSmaller": True}, {"mesh": {"data": 1}},
])
def test_make_mesh_lays_out_and_clamps_as_the_jax_package(conf):
    mine = make_mesh(MeshConfig.from_json(conf), devices=CPU8)
    theirs = jax_make_mesh(JaxMeshConfig.from_json(conf), devices=JAX8)
    assert _shape(mine) == _shape(theirs)
    assert mine.axis_names == tuple(theirs.axis_names)
    assert mine.size == theirs.devices.size
    assert mine.devices.shape == theirs.devices.shape
    assert all(d == torch.device("cpu") for d in mine.slots)
    assert (mine.processes == 0).all()


@pytest.mark.parametrize("conf", [
    {"mesh": {"data": 16}, "allowSmaller": False},
    {"mesh": {"data": 4, "model": 4}, "allowSmaller": False},
])
def test_too_large_a_mesh_without_allow_smaller_raises_the_jax_message(conf):
    with pytest.raises(ValueError) as theirs:
        jax_make_mesh(JaxMeshConfig.from_json(conf), devices=JAX8)
    with pytest.raises(ValueError) as mine:
        make_mesh(MeshConfig.from_json(conf), devices=CPU8)
    assert str(mine.value) == str(theirs.value) == "mesh needs 16 devices, have 8"


def test_mesh_config_from_json_equals_the_jax_packages():
    for obj in (None, {}, {"mesh": {"data": "4"}}, {"allowSmaller": False},
                {"mesh": {"data": 2, "model": 2}, "allowSmaller": 0}):
        mine, theirs = MeshConfig.from_json(obj), JaxMeshConfig.from_json(obj)
        assert (mine.axes, mine.allow_smaller) == (theirs.axes, theirs.allow_smaller)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shards_mesh_never_clamps(n):
    mine, theirs = shards_mesh(n, CPU8), jax_shards_mesh(n, JAX8)
    assert _shape(mine) == _shape(theirs) == {"shards": n}
    with pytest.raises(ValueError, match=f"mesh needs {2 * n + 8} devices, have 8"):
        shards_mesh(2 * n + 8, CPU8)
    with pytest.raises(ValueError, match=f"mesh needs {2 * n + 8} devices, have 8"):
        jax_shards_mesh(2 * n + 8, JAX8)


def test_default_devices_follow_the_platform(monkeypatch):
    # the CPU platform is one CPU; an empty config puts it on "data"
    assert platform_devices("cpu") == [torch.device("cpu")]
    mesh = make_mesh(platform="cpu")
    assert _shape(mesh) == {"data": 1} and mesh.slots == [torch.device("cpu")]
    monkeypatch.setenv("PIO_MESH_PLATFORM", "cpu")
    assert make_mesh(MeshConfig({"data": 4})).size == 1
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        make_mesh(MeshConfig({"data": 4}, allow_smaller=False))
    # no card and no CPU request: the port's entry points raise
    monkeypatch.delenv("PIO_MESH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="unsupported mesh platform"):
        platform_devices("tpu")


def test_pad_to_multiple_and_one_slot():
    """``pad_to_multiple`` is the JAX package's; ``process_slots`` gives a
    one-process path every slot, or those along one axis, and refuses a
    mesh whose slots span processes."""
    for n, m in ((0, 8), (1, 8), (8, 8), (9, 8), (41, 3)):
        assert pad_to_multiple(n, m) == jax_pad(n, m)
    mesh = make_mesh(MeshConfig({"data": 2, "model": 4}), devices=CPU8)
    assert process_slots(mesh, "x") == mesh.slots and len(mesh.slots) == 8
    assert len(process_slots(mesh, "x", "data")) == 2
    assert len(process_slots(mesh, "x", "model")) == 4
    assert process_slots(make_mesh(devices=["cpu"]), "x") == [torch.device("cpu")]
    spans = Mesh(mesh.devices, mesh.axis_names, np.arange(8).reshape(2, 4) // 4)
    with pytest.raises(ValueError) as e:
        process_slots(spans, "data-parallel naive Bayes")
    assert str(e.value) == ("data-parallel naive Bayes runs over the slots of one "
                            "process; this mesh spans processes [0, 1]")


def test_ring_attention_takes_a_mesh_and_refuses_more_than_one_slot():
    """A one-slot mesh is the local oracle; eight slots run the ring and
    give the JAX package's ring over its eight devices."""
    q = torch.randn(1, 8, 2, 8, generator=torch.Generator().manual_seed(0))
    one = ring_attention(q, q, q, mesh=make_mesh(devices=["cpu"]))
    torch.testing.assert_close(one, ring_attention(q, q, q))
    eight = ring_attention(q, q, q, mesh=make_mesh(devices=CPU8), causal=True)
    jq = jax.numpy.asarray(q.numpy())
    want = jax_ring(jq, jq, jq, mesh=jax_make_mesh(devices=JAX8), causal=True)
    np.testing.assert_allclose(eight.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_single_process_shell_degenerates_as_the_jax_packages():
    assert distributed.initialize() is jax_dist.initialize() is False
    assert distributed.process_count() == jax_dist.process_count() == 1
    assert distributed.process_index() == jax_dist.process_index() == 0
    assert distributed.is_coordinator() and jax_dist.is_coordinator()
    distributed.barrier("pio_test")
    tree = {"a": np.arange(3)}
    out = distributed.broadcast_from_coordinator(tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert distributed.broadcast_string("inst-xyz") == jax_dist.broadcast_string("inst-xyz")
    assert distributed.local_devices("cpu") == [torch.device("cpu")]
    assert distributed.global_slots("cpu") == ([torch.device("cpu")], [0])
    part = torch.arange(6.0).reshape(3, 2)
    assert distributed.all_gather_parts(part) is part
    mesh = make_mesh(MeshConfig({"data": 8}), devices=CPU8)
    assert isinstance(mesh, Mesh) and mesh.local_slots() == list(range(8))


def test_config_from_env_equals_the_jax_packages(monkeypatch):
    monkeypatch.setenv("PIO_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("PIO_NUM_PROCESSES", "4")
    monkeypatch.setenv("PIO_PROCESS_ID", "2")
    mine = distributed.DistributedConfig.from_env()
    theirs = jax_dist.DistributedConfig.from_env()
    assert mine.requested and theirs.requested
    assert (mine.coordinator_address, mine.num_processes, mine.process_id) \
        == (theirs.coordinator_address, theirs.num_processes, theirs.process_id) \
        == ("10.0.0.1:1234", 4, 2)
