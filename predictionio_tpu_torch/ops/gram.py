"""Fused gather → weighted Gram: the ALS training inner op.

For every padded rating row ``r`` of a bucket,

    A[r] = Σ_c wo[r,c] · F[idx[r,c]] F[idx[r,c]]ᵀ      (k × k)
    b[r] = Σ_c wb[r,c] · F[idx[r,c]]                    (k)

On the card this is the hand-written CUDA kernel in
``csrc/gather_gram.cu`` (the counterpart of the Pallas ``gather_gram`` of
the JAX package): the gathered (R, C, k) block never reaches device
memory. :func:`gather_gram_ref` is its plain PyTorch version (the JAX
package's ``gather_gram_xla``: gather, then two einsums in f32), which
the CPU takes and which the tests and ``chip_smoke.py`` hold the kernel
against. F may be f32 or bf16; bf16 rows are widened to f32 before use.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

#: the largest factor width the kernel takes (MAX_K in
#: csrc/gather_gram.cu, which refuses a larger k)
MAX_K = 128

_count_lock = threading.Lock()


def gather_gram_ref(F: torch.Tensor, idx: torch.Tensor, wo: torch.Tensor,
                    wb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: F (N, k), idx (R, C) int, wo/wb (R, C) →
    A (R, k, k) f32, b (R, k) f32."""
    Fg = F[idx.long()].float()                       # (R, C, k)
    A = torch.einsum("rc,rck,rcl->rkl", wo.float(), Fg, Fg)
    b = torch.einsum("rc,rck->rk", wb.float(), Fg)
    return A, b


def _bind():
    from predictionio_tpu_torch.ops import _build

    lib = _build.load("gather_gram")
    if not getattr(lib, "_pio_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pio_gather_gram.argtypes = [p, i, i, p, p, p, ctypes.c_longlong, i,
                                        p, p, p]
        lib.pio_gather_gram.restype = ctypes.c_int
        lib._pio_bound = True
    return lib


def gather_gram(F: torch.Tensor, idx: torch.Tensor, wo: torch.Tensor,
                wb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gather → weighted Gram: F (N, k) f32/bf16, idx (R, C) int32
    with every entry in [0, N) (the kernel does not check: that would
    cost a device sync per call), wo/wb (R, C) f32 → A (R, k, k) f32
    (both triangles), b (R, k) f32.

    A CPU tensor takes :func:`gather_gram_ref`; a CUDA tensor launches the
    kernel (k ≤ :data:`MAX_K`) or raises. R = 0 launches nothing."""
    if F.dim() != 2 or idx.dim() != 2 or wo.shape != idx.shape \
            or wb.shape != idx.shape:
        raise ValueError(f"gather_gram needs F (N, k) and idx/wo/wb (R, C); got "
                         f"{tuple(F.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(wo.shape)}, {tuple(wb.shape)}")
    if not (F.device == idx.device == wo.device == wb.device):
        raise ValueError("gather_gram: F, idx, wo and wb must share one device")
    R, C = idx.shape
    k = F.shape[1]
    if F.device.type == "cpu":
        return gather_gram_ref(F, idx, wo, wb)
    if F.device.type != "cuda":
        raise ValueError(f"gather_gram: no kernel for device {F.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gather_gram: k={k} outside 1..{MAX_K}")
    if F.dtype not in (torch.float32, torch.bfloat16) or not F.is_contiguous():
        raise ValueError("gather_gram: F must be contiguous float32 or bfloat16")
    for name, t, dtype in (("idx", idx, torch.int32), ("wo", wo, torch.float32),
                           ("wb", wb, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"gather_gram: {name} must be contiguous {dtype}")
    A = torch.empty((R, k, k), dtype=torch.float32, device=F.device)
    b = torch.empty((R, k), dtype=torch.float32, device=F.device)
    if R == 0:
        return A, b
    lib = _bind()
    with torch.cuda.device(F.device):
        rc = lib.pio_gather_gram(
            F.data_ptr(), int(F.dtype == torch.bfloat16), k, idx.data_ptr(),
            wo.data_ptr(), wb.data_ptr(), R, C, A.data_ptr(), b.data_ptr(),
            torch.cuda.current_stream(F.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_gram kernel launch failed: CUDA error {rc}")
    with _count_lock:
        gather_gram.launches += 1
    return A, b


#: kernel launches since the last reset (chip_smoke.py shows the training
#: path went through the kernel)
gather_gram.launches = 0
