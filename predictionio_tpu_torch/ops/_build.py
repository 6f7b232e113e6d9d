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
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": build wall time (0.0 when the library was
#: already on disk), "log": nvcc's output, -Xptxas -v included}
BUILD_INFO: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        info = {"seconds": 0.0, "log": ""}
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(nvcc_command(src, tmp), capture_output=True,
                                  text=True, check=False)
            info["seconds"] = time.perf_counter() - t0
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                    f"{info['log']}")
            os.replace(tmp, out)
        BUILD_INFO[name] = info
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
