"""Batched SPD solve: the ALS normal-equation solver.

``A x = b`` for a batch of k × k symmetric positive definite systems
(ALS adds a ``λ·n·I`` ridge). On the card this is the hand-written CUDA
kernel in ``csrc/chol_solve.cu`` (the counterpart of the Pallas
``chol_solve_pallas`` of the JAX package): one Cholesky factorisation,
forward and back substitution per system, with every diagonal pivot
floored as ``sqrt(max(d, 1e-30))`` so identity and pad systems give
``x = b`` exactly. :func:`chol_solve_ref` is its plain PyTorch version
(``torch.linalg.cholesky`` + two triangular solves in f32), which the CPU
takes and which the tests and ``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: the largest system size the kernel takes (MAX_K in csrc/chol_solve.cu,
#: which refuses a larger k)
MAX_K = 128

_count_lock = threading.Lock()


def chol_solve_ref(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: A (N, k, k) SPD, b (N, k) → x (N, k), f32."""
    if A.shape[0] == 0:
        return torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    L = torch.linalg.cholesky(A.float())
    y = torch.linalg.solve_triangular(L, b.float()[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _bind():
    from predictionio_tpu_torch.ops import _build

    lib = _build.load("chol_solve")
    if not getattr(lib, "_pio_bound", False):
        p = ctypes.c_void_p
        lib.pio_chol_solve.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p]
        lib.pio_chol_solve.restype = ctypes.c_int
        lib._pio_bound = True
    return lib


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (N, k, k) f32 SPD, b (N, k) f32 → x (N, k) f32, for any
    1 ≤ k ≤ :data:`MAX_K` and N ≥ 0.

    A CPU tensor takes :func:`chol_solve_ref`; a CUDA tensor launches the
    kernel or raises. N = 0 launches nothing."""
    if A.dim() != 3 or b.dim() != 2 or A.shape[1:] != (b.shape[1], b.shape[1]) \
            or A.shape[0] != b.shape[0]:
        raise ValueError(f"chol_solve needs A (N, k, k) and b (N, k); got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if A.device != b.device:
        raise ValueError("chol_solve: A and b must share one device")
    N, k = b.shape
    if A.device.type == "cpu":
        return chol_solve_ref(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"chol_solve: no kernel for device {A.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"chol_solve: k={k} outside 1..{MAX_K}")
    for name, t in (("A", A), ("b", b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"chol_solve: {name} must be contiguous float32")
    x = torch.empty((N, k), dtype=torch.float32, device=A.device)
    if N == 0:
        return x
    lib = _bind()
    with torch.cuda.device(A.device):
        rc = lib.pio_chol_solve(A.data_ptr(), b.data_ptr(), x.data_ptr(), N, k,
                                torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error {rc}")
    with _count_lock:
        chol_solve.launches += 1
    return x


#: kernel launches since the last reset (chip_smoke.py shows the training
#: path went through the kernel)
chol_solve.launches = 0
