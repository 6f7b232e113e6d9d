"""Build and bind the hand-written CUDA kernels.

Each source in ``predictionio_tpu_torch/csrc/`` has a plain C interface.
At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/torch_kernels/`` at the root of the
checkout, and loaded with :mod:`ctypes`. The library's file name carries
a digest of the source and the flags, so an edited source is rebuilt
and a stale one is never loaded. Nothing here runs at import time: the
CPU tests import every module of the package on machines with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source built by this process: {"seconds": nvcc's wall time,
#: "log": nvcc's output, -Xptxas -v included}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the file name carries a digest
    of the source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> None:
    """Compile every source of ``names`` whose library is not on disk:
    one ``nvcc`` per source, all started together."""
    with _lock:
        started = []
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", tmp),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((name, out, tmp, proc, time.perf_counter()))
        failed = []
        for name, out, tmp, proc, t0 in started:
            log = proc.communicate()[0]
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {CSRC / f'{name}.cu'} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
