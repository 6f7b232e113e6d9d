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


# -- PQ asymmetric-distance scan + re-rank (the ann subsystem's math) ---------
#
# Plain PyTorch (the JAX package computes these with XLA ops, not a Pallas
# kernel): ``ann/scorer.py`` runs gather → ADC scan → shortlist → exact
# re-rank as one serving program per AOT bucket; the math lives here
# beside the exact path's, and the caller owns residency.
#
# Tie order. ``lax.top_k`` gives the lowest index first among equal
# values, and ADC scores tie EXACTLY whenever two items share a code word;
# ``torch.topk`` promises no order among ties. So every top-k here runs
# over a 64-bit key, the score's order-preserving integer image in the
# high half and the complement of the column in the low half: keys are
# unique, larger means (score higher, or equal and column lower), and the
# result is the JAX package's whatever tiling and device.

#: columns per streamed ADC tile in the JAX package, whose one-dense-tile
#: rule (``N <= 2 * chunk or kprime > chunk``) picks the same shortlist as
#: any tiling here
_ADC_CHUNK = 32768

#: elements of the live (B, tile) score set of one streamed tile: the tile
#: width is this over the batch, never below ``_ADC_CHUNK``
_ADC_TILE_ELEMS = 1 << 24


def _order_keys(s: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """(score descending, column ascending) as one int64 key a row.
    ``s`` f32 (B, n), ``col`` the int64 columns, (n,) or (B, n)."""
    bits = s.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return ordered * (1 << 32) + (0xFFFFFFFF - col)


def _topk_ordered(s: torch.Tensor, col: torch.Tensor, k: int):
    """Positions of the top ``k`` of each row of ``s`` by
    :func:`_order_keys`, in that order."""
    return torch.topk(_order_keys(s, col), k, dim=1, sorted=True).indices


def _adc_lut(Q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(m, B, K) table of query-subvector · centroid inner products
    (subspace-major: each ADC step reads one contiguous (B, K) table)."""
    B = Q.shape[0]
    m, K, dsub = codebooks.shape
    return torch.bmm(Q.reshape(B, m, dsub).transpose(0, 1),
                     codebooks.transpose(1, 2))


def _adc_sum(lut: torch.Tensor, codesT: torch.Tensor) -> torch.Tensor:
    """Sum LUT entries along each item's code word → (B, n) scores, the
    subspaces added in order onto zeros (the JAX package's sum)."""
    idx = codesT.to(torch.int32)
    scores = torch.zeros((lut.shape[1], codesT.shape[1]), dtype=torch.float32,
                         device=lut.device)
    for mi in range(codesT.shape[0]):
        scores += lut[mi].index_select(1, idx[mi])
    return scores


def adc_scores(Q: torch.Tensor, codebooks: torch.Tensor,
               codesT: torch.Tensor) -> torch.Tensor:
    """Asymmetric-distance (inner-product) scores of queries against a
    product-quantized corpus, dense: (B, N).

    ``Q``: (B, d) f32 queries; ``codebooks``: (m, K, d/m) PQ centroids;
    ``codesT``: (m, N) uint8 code matrix (transposed so each subspace's
    codes are contiguous). Materializes the full (B, N) score matrix;
    the serving path uses :func:`adc_shortlist`, which streams.
    """
    return _adc_sum(_adc_lut(Q, codebooks), codesT)


def adc_shortlist(Q: torch.Tensor, codebooks: torch.Tensor,
                  codesT: torch.Tensor, kprime: int,
                  tile: Optional[int] = None, *, n_valid: int = 0,
                  col_offset: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``kprime`` shortlist by ADC score → (vals f32, idx i32), each
    (B, k′), ordered by score descending, ties to the lower item.

    Streams the corpus in ``tile``-column tiles (default: the width that
    keeps the live (B, tile) set at ``_ADC_TILE_ELEMS``): each tile keeps
    its top k′ and one final top k′ over the tile winners merges them.
    Every global winner wins its own tile under the key order, so the
    result is a dense top-k′'s, and the JAX package's, for every width.

    Sharded serving runs this per slot on a contiguous column block of
    the global code matrix: ``col_offset`` is added to the returned
    indices (and to the tie keys) so they are GLOBAL corpus rows, and
    ``n_valid`` (the global real item count) scores pad columns past the
    corpus tail ``_NEG``. The defaults leave the one-device path
    byte-identical.
    """
    N = codesT.shape[1]
    B = Q.shape[0]
    lut = _adc_lut(Q, codebooks)
    if tile is None:
        tile = max(_ADC_CHUNK, _ADC_TILE_ELEMS // max(B, 1))
    cols = torch.arange(N, dtype=torch.int64, device=Q.device)
    if col_offset is not None:
        cols = cols + int(col_offset)

    def scan(lo: int, hi: int) -> torch.Tensor:
        s = _adc_sum(lut, codesT[:, lo:hi])
        if n_valid:
            s.masked_fill_(cols[lo:hi] >= n_valid, _NEG)
        return s

    if N <= tile or kprime > tile:   # one dense tile
        s = scan(0, N)
        pos = _topk_ordered(s, cols, kprime)
        return s.gather(1, pos), cols[pos].to(torch.int32)
    vals, idx, keys = [], [], []
    for lo in range(0, N, tile):
        s = scan(lo, min(lo + tile, N))
        key = _order_keys(s, cols[lo:lo + s.shape[1]])
        kk, pos = torch.topk(key, min(kprime, s.shape[1]), dim=1, sorted=True)
        keys.append(kk)
        vals.append(s.gather(1, pos))
        idx.append(cols[lo + pos])
    loc = torch.topk(torch.cat(keys, 1), kprime, dim=1, sorted=True).indices
    return (torch.cat(vals, 1).gather(1, loc),
            torch.cat(idx, 1).gather(1, loc).to(torch.int32))


def merge_shortlists(vals: torch.Tensor, idx: torch.Tensor, kprime: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed top-k′ merge: (S, B, k′) per-shard shortlists, each
    holding GLOBAL rows, → the global (B, k′) (vals, idx i32).

    A small dense top-k′ over the (k′ · S) gathered candidates under the
    key order (score descending, row ascending): every global winner won
    its own shard, so this is the dense top-k′ of the whole corpus, ties
    included, and with one shard it returns its input unchanged.
    """
    S, B, kp = vals.shape
    v = vals.permute(1, 0, 2).reshape(B, S * kp)
    i = idx.permute(1, 0, 2).reshape(B, S * kp)
    pos = _topk_ordered(v, i.to(torch.int64), kprime)
    return v.gather(1, pos), i.gather(1, pos).to(torch.int32)


def rerank_partial(Q: torch.Tensor, V_local: torch.Tensor, idx: torch.Tensor,
                   col_offset: int) -> torch.Tensor:
    """This shard's share of the exact re-rank of a GLOBAL candidate
    list: the scores of the candidates whose row lives in ``V_local``
    (rows [col_offset, col_offset + local_n)), 0.0 elsewhere, so the sum
    over the shards assembles the exact scores without gathering V.

    Out-of-shard rows clip to a valid local row and are masked to 0.0,
    so every shard does the same work. Each owned score is computed as
    :func:`rerank_topk` computes it.
    """
    local_n = V_local.shape[0]
    idx = idx.to(torch.int64)
    own = (idx >= col_offset) & (idx < col_offset + local_n)
    lrow = torch.clamp(idx - col_offset, 0, local_n - 1)
    Vs = V_local[lrow]                                      # (B, k', d)
    exact = torch.bmm(Vs, Q[:, :, None])[..., 0]
    return torch.where(own, exact, torch.zeros_like(exact))


def rerank_topk(Q: torch.Tensor, V: torch.Tensor, shortlist_idx: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of a per-row shortlist against float embeddings.

    Gathers only the (B, k′, d) shortlist rows of ``V`` — never the
    full corpus — scores them exactly, and returns the top-``k``
    (vals, idx i32) with ``idx`` mapped back to corpus rows; equal
    scores keep their shortlist order.
    """
    Vs = V[shortlist_idx.long()]                            # (B, k', d)
    exact = torch.bmm(Vs, Q[:, :, None])[..., 0]
    pos = _topk_ordered(exact, torch.arange(exact.shape[1], dtype=torch.int64,
                                            device=exact.device), k)
    return exact.gather(1, pos), shortlist_idx.gather(1, pos).to(torch.int32)
