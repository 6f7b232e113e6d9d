"""Weighted Gram over a pre-gathered block.

For every row ``r`` of a (R, W, k) block of factor rows,

    A[r] = F_g[r]ᵀ · diag(w_outer[r]) · F_g[r]      (k × k)
    b[r] = F_g[r]ᵀ · w_b[r]                         (k)

On the card this is the hand-written CUDA kernel in ``csrc/rows_gram.cu``
(the counterpart of the Pallas ``rows_gram`` of the JAX package, whose
``block_rows`` and ``interpret`` are TPU tiling details and are not
carried over). :func:`rows_plan` decides from the shape alone how the
rows are laid on blocks: the wide rows of few-row blocks are split into
chunks that a second kernel sums in a fixed order; the narrow rows of
many-row blocks are packed several to a block. :func:`rows_gram_ref` is
its plain PyTorch version (the JAX package's ``rows_gram_xla``: two
einsums in f32), which the CPU takes and which the tests and
``chip_smoke.py`` hold the kernel against. F_g may be f32 or bf16; bf16
values are widened to f32 before use.

This module does not import :mod:`.gram` (which re-exports it), so its
plan is a copy of ``gram_plan``'s rule with its own constants.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch

#: the largest factor width the kernel takes (MAX_K in
#: csrc/rows_gram.cu, which refuses a larger k)
MAX_K = 128
#: packing: in a block of at least PACK_ROWS narrow rows (W <= NARROW), a
#: CUDA block takes about PACK_SLOTS slots of consecutive rows, at least 2
#: rows and at most MAX_PACK, so the next row's copy overlaps this row's
#: products and the write of its A; wider rows already overlap their own
#: tiles (more rows a block measured slower on the card)
NARROW, PACK_ROWS, PACK_SLOTS, MAX_PACK = 32, 4096, 32, 4
#: splitting: rows are cut until about SPLIT_BLOCKS blocks run, into at
#: most MAX_SPLIT chunks of at least MIN_CHUNK slots; a chunk is a whole
#: number of LINE slots (128-byte lines of the weights)
SPLIT_BLOCKS, MAX_SPLIT, MIN_CHUNK, LINE = 2048, 16, 512, 32

_count_lock = threading.Lock()


def rows_gram_ref(F_g: torch.Tensor, w_outer: torch.Tensor,
                  w_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: F_g (R, W, k), w_outer/w_b (R, W) → A (R, k, k) f32,
    b (R, k) f32."""
    F = F_g.float()
    A = torch.einsum("rw,rwk,rwl->rkl", w_outer.float(), F, F)
    b = torch.einsum("rw,rwk->rk", w_b.float(), F)
    return A, b


class RowsPlan(NamedTuple):
    """How one launch lays rows on blocks: with ``split`` > 1 each row is
    cut into ``split`` chunks of ``chunk`` slots, one block each; else a
    block takes ``rows_per_block`` whole rows."""
    split: int
    chunk: int
    rows_per_block: int


def rows_plan(R: int, W: int) -> RowsPlan:
    """The kernel's plan for an (R, W) block, from the shape alone (the
    same shape always takes the same plan, so a rerun sums in the same
    order)."""
    split = max(1, min(MAX_SPLIT, -(-SPLIT_BLOCKS // max(R, 1)), W // MIN_CHUNK))
    if split == 1:
        pack = W <= NARROW and R >= PACK_ROWS
        return RowsPlan(1, W, min(MAX_PACK, max(2, PACK_SLOTS // W)) if pack else 1)
    chunk = -(-W // (split * LINE)) * LINE
    return RowsPlan(-(-W // chunk), chunk, 1)


def _bind():
    from predictionio_tpu_torch.ops import _build

    lib = _build.load("rows_gram")
    if not getattr(lib, "_pio_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pio_rows_gram.argtypes = [p, i, i, p, p, ctypes.c_longlong, i, i, i, i,
                                      p, p, p, p]
        lib.pio_rows_gram.restype = ctypes.c_int
        lib._pio_bound = True
    return lib


def rows_gram(F_g: torch.Tensor, w_outer: torch.Tensor,
              w_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Gram: F_g (R, W, k) f32/bf16, w_outer/w_b (R, W) f32 →
    A (R, k, k) f32 (both triangles, exactly symmetric), b (R, k) f32. The
    kernel skips the slots of zero weight past each tile's last nonzero
    one, so a non-finite row of F_g at such a slot does not give the plain
    version's 0·Inf = NaN.

    A CPU tensor takes :func:`rows_gram_ref`; a CUDA tensor launches the
    kernel (1 ≤ k ≤ :data:`MAX_K`, W ≥ 1) or raises. R = 0 launches
    nothing."""
    if F_g.dim() != 3 or w_outer.shape != F_g.shape[:2] \
            or w_b.shape != F_g.shape[:2]:
        raise ValueError(f"rows_gram needs F_g (R, W, k) and w_outer/w_b (R, W); "
                         f"got {tuple(F_g.shape)}, {tuple(w_outer.shape)}, "
                         f"{tuple(w_b.shape)}")
    if not (F_g.device == w_outer.device == w_b.device):
        raise ValueError("rows_gram: F_g, w_outer and w_b must share one device")
    R, W, k = F_g.shape
    if F_g.device.type == "cpu":
        return rows_gram_ref(F_g, w_outer, w_b)
    if F_g.device.type != "cuda":
        raise ValueError(f"rows_gram: no kernel for device {F_g.device}")
    if not 1 <= k <= MAX_K or W < 1:
        raise ValueError(f"rows_gram: k={k} outside 1..{MAX_K} or W={W} < 1")
    if F_g.dtype not in (torch.float32, torch.bfloat16) or not F_g.is_contiguous():
        raise ValueError("rows_gram: F_g must be contiguous float32 or bfloat16")
    for name, t in (("w_outer", w_outer), ("w_b", w_b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"rows_gram: {name} must be contiguous float32")
    A = torch.empty((R, k, k), dtype=torch.float32, device=F_g.device)
    b = torch.empty((R, k), dtype=torch.float32, device=F_g.device)
    if R == 0:
        return A, b
    plan = rows_plan(R, W)
    # the split chunks' partial [A | b], summed in chunk order on the card
    partial = (torch.empty((R * plan.split, k * k + k), dtype=torch.float32,
                           device=F_g.device) if plan.split > 1 else None)
    lib = _bind()
    with torch.cuda.device(F_g.device):
        rc = lib.pio_rows_gram(
            F_g.data_ptr(), int(F_g.dtype == torch.bfloat16), k, w_outer.data_ptr(),
            w_b.data_ptr(), R, W, *plan, A.data_ptr(), b.data_ptr(),
            None if partial is None else partial.data_ptr(),
            torch.cuda.current_stream(F_g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rows_gram kernel launch failed: CUDA error {rc}")
    with _count_lock:
        rows_gram.launches += 1
    return A, b


#: kernel launches since the last reset (chip_smoke.py shows the op entry
#: point went through the kernel)
rows_gram.launches = 0
