"""The port's multi-process path: REAL two-process ``torch.distributed``
runs over localhost on gloo (the cases of ``tests/test_multihost.py``).

Each test spawns two port processes with the ``PIO_*`` rendezvous
variables and two CPU slots each, a four-slot mesh split across the
processes. ``run_train`` must rendezvous, train sharded ALS with the
factor blocks exchanged between the processes, and leave ONE COMPLETED
instance whose model equals a one-process four-slot train's.
"""

import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "predictionio_tpu_torch.templates.recommendation.engine:engine_factory"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_") and k != "PYTEST_CURRENT_TEST"}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _run_pair(script: str, extra_env=None, timeout=180):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script],
        env=_env({**(extra_env or {}), "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                  "PIO_NUM_PROCESSES": "2", "PIO_PROCESS_ID": str(i)}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outs


COLLECTIVES = textwrap.dedent("""
    import numpy as np
    import torch

    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    multi = distributed.initialize(slots=["cpu", "cpu"])  # from the PIO_* env
    assert multi, "expected multi-process"
    assert distributed.process_count() == 2
    assert len(distributed.local_devices()) == 2
    assert len(distributed.global_devices()) == 4
    distributed.barrier("pio_test_start")

    # control-plane broadcast (the coordinator's value wins)
    me = distributed.process_index()
    val = distributed.broadcast_from_coordinator(
        np.asarray([41.0 if me == 0 else -1.0], np.float32))
    assert float(val[0]) == 41.0, val
    sid = distributed.broadcast_string("inst-xyz" if me == 0 else "")
    assert sid == "inst-xyz", sid

    # a sum over the four slots of the global mesh
    mesh = make_mesh(MeshConfig({"data": 4}))
    assert mesh.processes.ravel().tolist() == [0, 0, 1, 1], mesh
    x = np.arange(8, dtype=np.float32)
    local = torch.stack([torch.as_tensor(x[2 * s:2 * s + 2]).sum()
                         for s in mesh.local_slots()])
    total = distributed.all_gather_parts(local).sum()
    assert float(total) == 28.0, total
    distributed.barrier("pio_test_done")
    distributed.shutdown()
    print("COLLECTIVES_OK", me)
""")


TRAIN = textwrap.dedent("""
    import os, sys

    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.models import als_sharded
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.storage.registry import Storage, StorageConfig

    sharded = als_sharded.als_train_sharded

    def traced(coo, p, mesh, **kw):
        print("SHARDED", mesh.size, mesh.local_slots())
        return sharded(coo, p, mesh, **kw)

    als_sharded.als_train_sharded = traced
    # two CPU slots a process (one process alone: four)
    distributed.initialize(slots=["cpu"] * int(sys.argv[1]))
    st = Storage(StorageConfig(home=os.environ["PIO_HOME"]))
    VARIANT = {
        "id": "default",
        "engineFactory": %r,
        "datasource": {"params": {"appName": "MHApp"}},
        "algorithms": [{"name": "als",
                        "params": {"rank": 4, "numIterations": 2,
                                   "lambda": 0.1}}],
    }
    iid = run_train(VARIANT["engineFactory"], variant=VARIANT, storage=st,
                    device="cpu")
    print("TRAIN_OK", distributed.process_index(), iid)
    distributed.shutdown()
""" % FACTORY)


def test_rendezvous_barrier_broadcast_and_a_sum_over_four_slots():
    outs = _run_pair(COLLECTIVES)
    assert all("COLLECTIVES_OK" in o for o in outs)


def test_run_train_two_processes(tmp_path):
    from predictionio_tpu.storage.registry import Storage as JaxStorage
    from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
    from predictionio_tpu_torch.core.workflow import prepare_deploy
    from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
    from tests.test_workflow import seed_ratings

    # one SQLite event store both processes read (the homes are twins)
    home, alone = str(tmp_path / "pio_home"), str(tmp_path / "one_process")
    seed_ratings(JaxStorage(JaxStorageConfig(metadata_type="SQLITE",
                                             eventdata_type="SQLITE",
                                             modeldata_type="LOCALFS", home=home)),
                 app_name="MHApp")
    shutil.copytree(home, alone)

    outs = _run_pair(TRAIN.replace("sys.argv[1]", "2"), extra_env={"PIO_HOME": home})
    ids = {[line for line in o.splitlines() if line.startswith("TRAIN_OK")][-1].split()[-1]
           for o in outs}
    assert len(ids) == 1, f"instance id differed across processes: {ids}"
    assert "SHARDED 4 [0, 1]" in outs[0] and "SHARDED 4 [2, 3]" in outs[1], outs

    # coordinator-only writes: exactly ONE engine instance row, COMPLETED,
    # and a loadable model
    st = Storage(StorageConfig(home=home))
    [inst] = st.meta.list_engine_instances()
    assert inst.status == "COMPLETED" and inst.id in ids
    dep = prepare_deploy(FACTORY, storage=st, device="cpu")
    assert len(dep.query({"user": "0", "num": 3})["itemScores"]) == 3

    # the same four slots in one process give the same factors
    proc = subprocess.run([sys.executable, "-c", TRAIN.replace("sys.argv[1]", "4")],
                          env=_env({"PIO_HOME": alone}), capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SHARDED 4 [0, 1, 2, 3]" in proc.stdout
    one = prepare_deploy(FACTORY, storage=Storage(StorageConfig(home=alone)),
                         device="cpu")
    two = dep.models[0]
    np.testing.assert_array_equal(two.U, one.models[0].U)
    np.testing.assert_array_equal(two.V, one.models[0].V)
