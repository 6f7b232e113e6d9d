"""Streaming score -> top-k over the item factors: the serving hot path.

Recommendation serving scores a query batch against the whole item
factor matrix and keeps the top k. On the card this is the hand-written
CUDA kernel in ``csrc/score_topk.cu`` (the counterpart of the Pallas
``score_topk`` of the JAX package); :func:`score_topk_ref` is its plain
PyTorch version, which the CPU takes and which the tests and
``chip_smoke.py`` hold the kernel against.

Contract, shared by both: scores are f32 ``Q · Vᵀ``; query rows at or
past ``rows_valid`` are zeroed (all-zero scores, defined outputs for the
pad rows of an AOT bucket); columns at or past ``n_valid`` score
``_NEG``; within a row the result is ordered by value descending, ties
going to the lowest column index.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

_NEG = -3.0e38  # finite "-inf", the JAX package's mask value

#: the largest k the kernel takes (MAX_K in csrc/score_topk.cu, which
#: refuses a larger k)
MAX_K = 1024

_count_lock = threading.Lock()


def _mask_pad_rows(Q: torch.Tensor, rows_valid: int) -> torch.Tensor:
    """Zero query rows at or past ``rows_valid``. Zeroed rows give
    all-zero scores and cannot perturb real rows (each row's top k is
    independent of the others)."""
    row = torch.arange(Q.shape[0], device=Q.device)[:, None]
    return torch.where(row < rows_valid, Q, torch.zeros_like(Q))


def score_topk_ref(Q: torch.Tensor, V: torch.Tensor, k: int, *,
                   n_valid: int = 0, rows_valid: Optional[int] = None,
                   ids: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the dense (B, N) f32 score matrix, masked, then a
    stable descending sort (``torch.topk`` promises no order among
    ties). ``ids`` gathers the query rows as ``Q[ids]``."""
    if ids is not None:
        Q = Q[ids.long()]
    if rows_valid is not None:
        Q = _mask_pad_rows(Q, rows_valid)
    scores = torch.matmul(Q.float(), V.float().T)
    if n_valid and n_valid < V.shape[0]:
        scores[:, n_valid:] = _NEG
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def _bind():
    from predictionio_tpu_torch.ops import _build

    lib = _build.load("score_topk")
    if not getattr(lib, "_pio_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pio_score_topk.argtypes = [p, i, p, p, i, i, i, i, i, i, p, p, p, p]
        lib.pio_score_topk.restype = ctypes.c_int
        lib.pio_score_topk_scratch_elems.argtypes = [i, i, i]
        lib.pio_score_topk_scratch_elems.restype = ctypes.c_longlong
        lib._pio_bound = True
    return lib


def score_topk(Q: torch.Tensor, V: torch.Tensor, k: int, *,
               n_valid: int = 0, rows_valid: Optional[int] = None,
               ids: Optional[torch.Tensor] = None,
               out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, d), (N, d) -> top-k (vals (B, k) f32, idx (B, k) i32) of Q·Vᵀ.

    ``ids`` (optional (B,) int32 on Q's device) gathers the query rows
    as ``Q[ids]`` inside the kernel, so the serving path passes the
    resident user factors and the batch's user rows. ``out`` takes
    preallocated (vals, idx). A CPU tensor takes :func:`score_topk_ref`;
    a CUDA tensor launches the kernel (k ≤ :data:`MAX_K`) or raises.
    """
    B = Q.shape[0] if ids is None else ids.shape[0]
    if Q.dim() != 2 or V.dim() != 2 or Q.shape[1] != V.shape[1]:
        raise ValueError(f"score_topk needs Q (n, d) and V (N, d); got "
                         f"{tuple(Q.shape)} and {tuple(V.shape)}")
    if Q.device != V.device or (ids is not None and ids.device != Q.device):
        raise ValueError("score_topk: Q, V and ids must share one device")
    if not 1 <= k <= min(MAX_K, V.shape[0]):
        raise ValueError(f"score_topk: k={k} outside 1..min({MAX_K}, "
                         f"{V.shape[0]} items)")
    if not 0 <= n_valid <= V.shape[0]:
        raise ValueError(f"score_topk: n_valid={n_valid} outside 0..{V.shape[0]}")
    rows_valid = B if rows_valid is None else int(rows_valid)
    if not 0 <= rows_valid <= B:
        raise ValueError(f"score_topk: rows_valid={rows_valid} outside 0..{B}")
    if Q.device.type == "cpu":
        vals, idx = score_topk_ref(Q, V, k, n_valid=n_valid,
                                   rows_valid=rows_valid, ids=ids)
        if out is None:
            return vals, idx
        out[0].copy_(vals)
        out[1].copy_(idx)
        return out
    if Q.device.type != "cuda":
        raise ValueError(f"score_topk: no kernel for device {Q.device}")
    for name, t, dtype in (("Q", Q, torch.float32), ("V", V, torch.float32),
                           ("ids", ids, torch.int32)):
        if t is not None and (t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"score_topk: {name} must be contiguous {dtype}")
    if out is None:
        vals = torch.empty((B, k), dtype=torch.float32, device=Q.device)
        idx = torch.empty((B, k), dtype=torch.int32, device=Q.device)
    else:
        vals, idx = out
        if (vals.shape != (B, k) or idx.shape != (B, k)
                or vals.dtype != torch.float32 or idx.dtype != torch.int32
                or not vals.is_contiguous() or not idx.is_contiguous()
                or vals.device != Q.device or idx.device != Q.device):
            raise ValueError("score_topk: out must be contiguous (B, k) "
                             "f32 and i32 on Q's device")
    lib = _bind()
    np_, d = V.shape
    with torch.cuda.device(Q.device):
        scratch = torch.empty(
            lib.pio_score_topk_scratch_elems(B, np_, k), dtype=torch.int64,
            device=Q.device)
        rc = lib.pio_score_topk(
            Q.data_ptr(), Q.shape[0], ids.data_ptr() if ids is not None else None,
            V.data_ptr(), np_, d, B, rows_valid, n_valid or np_, k,
            scratch.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(Q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"score_topk kernel launch failed: CUDA error {rc}")
    with _count_lock:
        score_topk.launches += 1
    return vals, idx


#: kernel launches since the last reset (chip_smoke.py shows the serving
#: path went through the kernel)
score_topk.launches = 0
