"""What every cell of the benchmark shares: the checkout's paths, the
manifest, seeds, caches, the device record, the check for JAX, and the
result line.

Nothing here imports the program; the drivers do, inside their calls.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

#: the root of the checkout the benchmark runs in (``benchmark/..``)
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
#: the package under test, which must be this checkout's own
PROGRAM = "predictionio_tpu_torch"
#: top-level module names that may never be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")
#: where the run keeps what it builds and writes, inside the checkout at
#: fixed paths (listed in .gitignore under build/)
CACHE_DIRS = {
    "TRITON_CACHE_DIR": ROOT / "build" / "bench_cache" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "bench_cache" / "torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": ROOT / "build" / "bench_cache" / "inductor",
}
RUN_DIR = ROOT / "build" / "bench_run"
#: inputs that are the same for every seed, made by a checkout's first run
DATA_CACHE = ROOT / "build" / "bench_cache" / "data"


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout, a fresh run
    directory for the program's home, and the port importable from the
    checkout's root. Keeps ``transformers`` and its kin from loading JAX."""
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    (RUN_DIR / "home").mkdir(parents=True)
    os.environ["PIO_HOME"] = str(RUN_DIR / "home")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def import_program():
    """Import the package under test and insist it is this checkout's:
    a benchmark in a tree without the program must fail, never find a
    copy elsewhere."""
    import importlib

    mod = importlib.import_module(PROGRAM)
    where = Path(mod.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"{PROGRAM} was imported from {where}, outside {ROOT}")
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(workload: str, man: Optional[dict] = None) -> Tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell, each found
    by its name: ``configs/<config>.json`` is the file the manifest names,
    ``traffic/<traffic>.json`` the mix."""
    man = man or manifest()
    wl = next((w for w in man["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == wl["config"])
    return wl, load_json(ROOT / conf["file"]), load_json(BENCH / "traffic" / f"{wl['traffic']}.json")


def cell_metrics(workload: str, man: Optional[dict] = None) -> Tuple[list, list]:
    """The end-to-end and per-layer metric entries the cell reports: those
    without ``workloads`` and those that list it."""
    man = man or manifest()

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return ([m for m in man["end_to_end"] if mine(m)],
            [m for m in man["per_layer"] if mine(m)])


def seed_int(seed: int) -> int:
    """Any whole number as a non-negative 63-bit seed."""
    return int(seed) % (1 << 63)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_record() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def device_record(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


class Clock:
    """Host-clock stages of the set-up, printed as they end."""

    def __init__(self, t0: float) -> None:
        self.t0 = t0
        self.stages: Dict[str, float] = {}

    def stage(self, name: str, t_start: float) -> float:
        dt = time.perf_counter() - t_start
        self.stages[name] = dt
        log(f"setup: {name} {dt:.3f} s (at {time.perf_counter() - self.t0:.3f} s)")
        return dt


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: Dict[str, Tuple[float, float]],
                breakdown: Optional[dict] = None) -> str:
    """The last line of standard output: the required keys, then
    ``checks``, each number compared beside its limit, last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out, allow_nan=False)


def _finite(v):
    """A number as JSON can hold it: a reading that is not finite is null."""
    return float(v) if v is not None and math.isfinite(v) else None
