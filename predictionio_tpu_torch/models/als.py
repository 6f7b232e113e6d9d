"""Alternating Least Squares: training and serving.

Training (``pio train``) builds the JAX package's bucketed layout on the
host (:func:`als_prepare`, copied so both packages give bitwise-equal
arrays) and runs the half-steps on the card: every bucket's normal
equations come from ONE launch of the hand-written ``gather_gram``
kernel (``ops/gram.py``), every part's systems are solved by ONE launch
of the ``chol_solve`` kernel (``ops/cholesky.py``), and the heaviest
entities (the dense head) are two plain matmuls. Serving keeps the
factor matrices resident on the card and answers each micro-batch with
one gather → score → top-k launch of the ``score_topk`` kernel
(``ops/topk.py``).

- :func:`init_factors` — the deterministic host-side factor init shared
  with the JAX package (same numpy draws, so seeded factors agree);
- :class:`RatingsCOO`, :class:`ALSParams`, :func:`als_prepare` — ratings,
  parameters and the host layout, copied from the JAX package;
- :func:`als_train`, :func:`als_train_prepared` — training on a device,
  optionally in checkpointed blocks that a restart resumes, or over a
  mesh of several slots (``models/als_sharded.py``);
- :func:`als_train_many`, :func:`als_train_scored`,
  :func:`als_sweep_program` — ``pio eval``'s grid: many candidates over
  one prepared, uploaded layout, serially or as sweep programs that
  score the held-out fold on the device;
- :func:`predict_ratings`, :func:`recommend`, :func:`similar_items` —
  host numpy scoring for small catalogs;
- :class:`ResidentScorer` — U and tile-padded V resident on the device,
  batches padded to the AOT bucket ladder, exclusions over-fetched; a
  query vector in place of a row of U (:meth:`recommend_vector`);
- :func:`similar_items_device` — :func:`similar_items` from a
  ``ResidentScorer(Vn, Vn)`` of the normalised V, one ``score_topk``
  launch a query;
- :func:`serve_on_device`, :func:`maybe_resident_scorer`,
  :func:`serve_topk_batch` — the serving policy the templates share.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import ops
from predictionio_tpu_torch.utils.device import full_f32, resolve_device


def init_factors(n: int, rank: int, seed: int) -> np.ndarray:
    """Deterministic host-side factor init (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, rank)) / np.sqrt(rank)).astype(np.float32)


@dataclass
class RatingsCOO:
    """Host-side ratings in COO form with dense entity indices."""

    user_idx: np.ndarray  # int32 [nnz]
    item_idx: np.ndarray  # int32 [nnz]
    rating: np.ndarray    # float32 [nnz]
    n_users: int
    n_items: int

    @property
    def nnz(self) -> int:
        return int(self.user_idx.shape[0])


@dataclass
class ALSParams:
    rank: int = 10
    iterations: int = 10
    reg: float = 0.01          # MLlib's `lambda`
    implicit: bool = False     # MLlib trainImplicit
    alpha: float = 1.0         # implicit confidence scale
    weighted_reg: bool = True  # ALS-WR: λ·n_e scaling (MLlib behavior)
    seed: int = 0
    # opt-in: gather factors in bfloat16 (half the bytes of the bucket
    # gathers; rows are widened to f32 before the Gram accumulates).
    # Off by default for reference-grade numerics.
    bf16_gather: bool = False


# -- bucketed layout ----------------------------------------------------------
#
# The JAX package's host layout, copied so that both packages build the
# same arrays bit for bit (with its default constants; the port has no
# environment overrides), for one device and, with common bounds, for
# each shard of models/als_sharded.py. Entities are sorted by rating
# count and padded to a ladder of widths, so each entity's normal
# equations are ONE row of a dense
# batched weighted Gram (no scatter); entities live in count-descending
# permuted order during training and factors are un-permuted once at the
# end. The reasons for each constant, and the TPU v5e measurements that
# chose them, are the JAX package's (its models/als.py).

# slab_entities × width bound of one slab (the seg bucket's aggregation
# unit)
_SLAB_ELEMS = 1 << 20

# Allowed padded widths: a ×4 ladder capped at 8 K; entities heavier than
# the cap are segmented across rows (the seg bucket, see _bucket_side).
_LADDER = (8, 32, 128, 512, 2048, 8192)
_C_MAX = _LADDER[-1]

# Dense-head crossover: entities with a count of at least n_other/14
# (and at least _DENSE_MIN_COUNT, which keeps small problems on the bucket
# path) skip the gather; their normal equations are two matmuls of dense
# per-entity (multiplicity, rating-sum) rows over the whole other side.
_DENSE_RATIO = 1.0 / 14.0
_DENSE_MIN_COUNT = 256
# Cap on the dense head's weight-row bytes (8 bytes per (entity, other)
# cell, on the host and the device); entities over it spill to the
# bucket path, which is always correct.
_DENSE_HEAD_MB = 2048


@dataclass
class _Bucket:
    """Entities sharing one padded width C, sliced into slabs.

    Two row↔entity regimes:
    - ``seg is None``: one row per entity (``counts`` is per-row,
      shaped (n_slabs, slab)).
    - ``seg`` set (the single heavy bucket, entities with more than
      ``_C_MAX`` ratings): each entity spans several width-C rows.
      Rows are entity-sorted, so a slab of S rows touches ≤ S
      CONSECUTIVE entities; ``seg`` is the (n_slabs, slab, slab)
      SLAB-LOCAL one-hot row→entity matrix (entity index relative to
      ``seg_off`` for that slab) that aggregates per-row partial Grams
      into per-entity normal equations with ONE batched matmul per slab
      (no scatter). Slab-local keeps ``seg`` at R×slab floats
      — a dense (R, nb) matrix would grow quadratically with the number
      of heavy entities. ``counts`` is per-entity, shaped (nb,).
    """

    C: int
    nb: int        # real entity count
    slab: int
    n_slabs: int
    other_idx: np.ndarray  # (n_slabs, slab, C) int32 — PERMUTED other pos
    vals: np.ndarray       # (n_slabs, slab, C) f32
    mask: np.ndarray       # (n_slabs, slab, C) f32
    counts: np.ndarray     # see class docstring
    seg: Optional[np.ndarray] = None
    seg_off: Optional[np.ndarray] = None  # (n_slabs,) int32 first entity

    @property
    def geometry(self) -> Tuple[int, int, int, int, bool]:
        return (self.C, self.nb, self.slab, self.n_slabs,
                self.seg is not None)


@dataclass
class _DenseHead:
    """The heaviest entities (see ``_DENSE_RATIO``): per-entity dense
    weight rows over the FULL other side. ``w_cnt[e, o]`` is the
    multiplicity of the (e, o) pair (0 almost everywhere), ``w_val``
    the rating sum — together they express exactly the same normal
    equations as the bucketed slots, as two GEMMs with no gather."""

    nb: int
    n_other: int
    w_cnt: np.ndarray   # (nb, n_other) f32
    w_val: np.ndarray   # (nb, n_other) f32
    counts: np.ndarray  # (nb,) f32 — rating count (ridge weighting)

    @property
    def geometry(self) -> Tuple[int, int]:
        return (self.nb, self.n_other)


@dataclass
class _BucketSide:
    """One half-step orientation: self entities bucketed, other side
    referenced by permuted position. ``dense`` (optional) covers the
    heaviest entities — permuted positions [0, dense.nb) — with the
    remaining entities in ``buckets``."""

    n: int
    perm: np.ndarray       # position p → original entity id
    inv_perm: np.ndarray   # original entity id → position
    buckets: list
    dense: Optional[_DenseHead] = None

    @property
    def geometry(self):
        return (self.n,
                self.dense.geometry if self.dense is not None else None,
                tuple(b.geometry for b in self.buckets))


def _perm_by_count_desc(counts: np.ndarray):
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return perm, inv


def _merge_bounds(counts_sorted_list, n_other: int) -> tuple:
    """Common bucket boundaries for one or many count-desc-sorted count
    vectors: ``(nb_dense, (nb_seg, seg_rows), ((width, nb), … desc))``.

    For the sharded path every shard must have the SAME geometry, so
    boundaries are the elementwise max over the shards' natural
    boundaries. Placing a lighter entity in a wider bucket (or the dense
    head) is always safe (capacity ≥ count — see ``_bucket_side``), so
    max-merging never breaks a shard, only pads it."""
    thresh = max(_DENSE_MIN_COUNT, int(_DENSE_RATIO * n_other))
    nb_dense = max(int((c >= thresh).sum()) for c in counts_sorted_list)
    # byte-cap the head (see _DENSE_HEAD_MB): counts are sorted
    # descending, so truncating keeps the heaviest — highest-payoff —
    # entities and spills the rest to the buckets below
    nb_dense = min(nb_dense, (_DENSE_HEAD_MB << 20) // max(1, 8 * n_other))
    nb_seg = max(int((c[nb_dense:] > _C_MAX).sum())
                 for c in counts_sorted_list)
    rows_cap = 0
    if nb_seg:
        for c in counts_sorted_list:
            seg_c = c[nb_dense:nb_dense + nb_seg]
            rows = int(((seg_c + _C_MAX - 1) // _C_MAX).sum())
            rows_cap = max(rows_cap, rows, 1)
    ladder = np.asarray(_LADDER, np.int64)
    nbs: dict = {}
    for c in counts_sorted_list:
        rest = c[nb_dense + nb_seg:]
        rest = rest[rest > 0]
        if rest.size:
            w, n = np.unique(ladder[np.searchsorted(ladder, rest)],
                             return_counts=True)
            for wi, ni in zip(w, n):
                nbs[int(wi)] = max(nbs.get(int(wi), 0), int(ni))
    regs = tuple(sorted(nbs.items(), reverse=True))
    return (nb_dense, (nb_seg, rows_cap), regs)


def _bucket_side(idx_self, idx_other_pos, vals, n_self, counts,
                 perm, inv_perm, n_other, bounds=None) -> _BucketSide:
    """Bucket one orientation. ``idx_other_pos`` must already be mapped
    to the other side's factor-row positions; ``counts/perm/inv_perm``
    come from :func:`_perm_by_count_desc` on this side's counts;
    ``n_other`` is the other side's factor-row count (the width of
    dense-head weight rows — the gathered factor matrix height).

    ``bounds`` forces common bucket boundaries (the sharded path: the
    max-merge over all shards, so every shard has one geometry). Forced
    boundaries are safe: the entity at permuted position p has count ≤
    every entity before it, and merged boundaries only ever move p into
    the dense head or a bucket at least as wide as its natural one — so
    capacity C ≥ count always holds."""
    nnz = idx_self.shape[0]
    pos = inv_perm[idx_self]
    order = np.argsort(pos, kind="stable")
    ps, o, v = pos[order], idx_other_pos[order], vals[order]
    counts_perm = counts[perm].astype(np.int64)
    starts = np.zeros(n_self + 1, np.int64)
    np.cumsum(counts_perm, out=starts[1:])
    within = (np.arange(nnz, dtype=np.int64) - starts[ps]).astype(np.int64)
    if bounds is None:
        bounds = _merge_bounds([counts_perm], n_other)
    nb_dense, (nb_seg, rows_cap), regs = bounds

    # dense head: heaviest entities (permuted positions [0, nb_dense))
    # as dense weight rows — see _DENSE_RATIO
    dense = None
    if nb_dense:
        hi = int(starts[min(nb_dense, n_self)])
        # bincount over linearized (entity, other) indices: np.add.at
        # is an unbuffered scalar scatter, ~50-100× slower over the
        # millions of nnz the dense head holds
        lin = ps[:hi].astype(np.int64) * n_other + o[:hi]
        size = nb_dense * n_other
        w_cnt = np.bincount(lin, minlength=size).astype(
            np.float32).reshape(nb_dense, n_other)
        w_val = np.bincount(lin, weights=v[:hi], minlength=size).astype(
            np.float32).reshape(nb_dense, n_other)
        cnts = np.zeros(nb_dense, np.float32)
        real = min(nb_dense, n_self)
        cnts[:real] = counts_perm[:real]
        dense = _DenseHead(nb_dense, n_other, w_cnt, w_val, cnts)
        # rebase the remainder so the seg/ladder code below sees a
        # self-contained problem over positions [nb_dense, n_self)
        ps = ps[hi:] - nb_dense
        o, v, within = o[hi:], v[hi:], within[hi:]
        counts_perm = counts_perm[nb_dense:]
        starts = starts[nb_dense:] - hi
        n_self_rest = max(n_self - nb_dense, 0)
    else:
        n_self_rest = n_self
    buckets = []

    # heavy entities (count > _C_MAX): one SEGMENTED bucket — each
    # entity spans ceil(count/C) rows of width C; the one-hot ``seg``
    # matrix aggregates row partials per entity on the device. Entities
    # are count-descending, so these are the first positions after the
    # dense head and the output concatenation order is preserved.
    if nb_seg:
        C = _C_MAX
        cnts = counts_perm[:nb_seg]
        rows_per = (cnts + C - 1) // C  # forced-in light entities: 1 row
        row_starts = np.zeros(nb_seg + 1, np.int64)
        np.cumsum(rows_per, out=row_starts[1:])
        n_rows = int(row_starts[-1])
        # slab capped at the (merged) row count: padding a small bucket to
        # a full slab made every tiny block solve tens of thousands of
        # identity systems
        slab = max(1, min(_SLAB_ELEMS // C, rows_cap))
        n_slabs = -(-rows_cap // slab)
        assert n_rows <= n_slabs * slab
        R = n_slabs * slab
        oi = np.zeros((R, C), np.int32)
        vv = np.zeros((R, C), np.float32)
        mm = np.zeros((R, C), np.float32)
        hi = int(starts[nb_seg])
        row = row_starts[ps[:hi]] + within[:hi] // C
        col = within[:hi] % C
        oi[row, col] = o[:hi]
        vv[row, col] = v[:hi]
        mm[row, col] = 1.0
        row_ent = np.repeat(np.arange(nb_seg), rows_per)
        # slab-local one-hot: entity index relative to the slab's first
        # entity (rows are entity-sorted → ≤ slab consecutive entities)
        if n_rows:
            seg_off = row_ent[np.minimum(np.arange(n_slabs) * slab,
                                         n_rows - 1)].astype(np.int32)
            local = row_ent - seg_off[np.arange(n_rows) // slab]
            seg = np.zeros((R, slab), np.float32)
            seg[np.arange(n_rows), local] = 1.0  # pad rows stay all-zero
        else:  # a shard with no ratings in the (forced) seg range
            seg_off = np.zeros(n_slabs, np.int32)
            seg = np.zeros((R, slab), np.float32)
        buckets.append(_Bucket(
            C, nb_seg, slab, n_slabs,
            oi.reshape(n_slabs, slab, C),
            vv.reshape(n_slabs, slab, C),
            mm.reshape(n_slabs, slab, C),
            cnts.astype(np.float32),
            seg=seg.reshape(n_slabs, slab, slab),
            seg_off=seg_off))

    # the rest: one row per entity, padded to the bucket width
    e = nb_seg
    for C, nb in regs:
        slab = max(1, min(_SLAB_ELEMS // C, nb))
        n_slabs = -(-nb // slab)
        nb_pad = n_slabs * slab
        oi = np.zeros((nb_pad, C), np.int32)
        vv = np.zeros((nb_pad, C), np.float32)
        mm = np.zeros((nb_pad, C), np.float32)
        # forced boundaries may extend past this shard's entities
        e_end = min(e + nb, n_self_rest)
        lo, hi = int(starts[min(e, n_self_rest)]), int(starts[e_end])
        row = (ps[lo:hi] - e).astype(np.int64)
        col = within[lo:hi]
        oi[row, col] = o[lo:hi]
        vv[row, col] = v[lo:hi]
        mm[row, col] = 1.0
        cnt = np.zeros(nb_pad, np.float32)
        cnt[: max(e_end - e, 0)] = counts_perm[e:e_end]
        buckets.append(_Bucket(
            C, nb, slab, n_slabs,
            oi.reshape(n_slabs, slab, C),
            vv.reshape(n_slabs, slab, C),
            mm.reshape(n_slabs, slab, C),
            cnt.reshape(n_slabs, slab)))
        e += nb
    return _BucketSide(n_self, perm, inv_perm, buckets, dense=dense)


@dataclass
class ALSPrepared:
    """Host-side prepared training layout (the analogue of MLlib ALS's
    InBlock construction — built once per dataset, reused across train
    calls; `bench.py` times training only, per BASELINE.md's
    "excluding data prep" protocol)."""

    n_users: int
    n_items: int
    nnz: int
    u_side: _BucketSide
    i_side: _BucketSide
    _device_bufs: Optional[tuple] = None  # (device, both sides' buffers)

    @property
    def geometry(self):
        return (self.u_side.geometry, self.i_side.geometry)



def als_prepare(coo: RatingsCOO) -> ALSPrepared:
    """Build the bucketed layout for single-device training."""
    cnt_u = np.bincount(coo.user_idx, minlength=coo.n_users)
    cnt_i = np.bincount(coo.item_idx, minlength=coo.n_items)
    perm_u, inv_u = _perm_by_count_desc(cnt_u)
    perm_i, inv_i = _perm_by_count_desc(cnt_i)
    u_side = _bucket_side(coo.user_idx, inv_i[coo.item_idx], coo.rating,
                          coo.n_users, cnt_u, perm_u, inv_u,
                          n_other=coo.n_items)
    i_side = _bucket_side(coo.item_idx, inv_u[coo.user_idx], coo.rating,
                          coo.n_items, cnt_i, perm_i, inv_i,
                          n_other=coo.n_users)
    return ALSPrepared(coo.n_users, coo.n_items, coo.nnz, u_side, i_side)


# -- training: the bucketed half-step on the device ----------------------------
#
# The reference's fused mode (gram_mode="pallas"): every bucket's rows go
# through ONE gather_gram launch, the seg bucket aggregates its row
# partials with one batched matmul against its slab-local one-hot and one
# index_add_, and the dense head is two plain matmuls. Each part (dense
# head, seg bucket, each regular bucket) is solved by ONE chol_solve launch
# as it is emitted, which gives the reference's materialized solve buffer's
# result without holding every side's k x k systems at once. The training
# loop is a plain Python loop over device tensors: no host sync inside.


def _side_buffers(side: _BucketSide, device: torch.device) -> tuple:
    """One side's layout on ``device``: ``(dense, buckets)`` with dense
    ``(w_cnt, w_val, counts)`` or None, and per bucket ``(other_idx, vals,
    mask, counts)`` flattened to its R = n_slabs · slab rows, plus, for the
    seg bucket, its ``(n_slabs, slab, slab)`` one-hot and the entity slot
    of each of its slab-local columns (``seg_off + arange(slab)``)."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    dense = None
    if side.dense is not None:
        d = side.dense
        dense = (put(d.w_cnt), put(d.w_val), put(d.counts))
    buckets = []
    for bk in side.buckets:
        R = bk.n_slabs * bk.slab
        bufs = (put(bk.other_idx.reshape(R, bk.C)), put(bk.vals.reshape(R, bk.C)),
                put(bk.mask.reshape(R, bk.C)), put(bk.counts.reshape(-1)))
        if bk.seg is not None:
            slots = (bk.seg_off.astype(np.int64)[:, None]
                     + np.arange(bk.slab, dtype=np.int64)).reshape(-1)
            bufs += (put(bk.seg), put(slots))
        buckets.append(bufs)
    return dense, tuple(buckets)


def _device_buffers(prep: ALSPrepared, device: torch.device) -> tuple:
    """Both sides' layout on ``device``, cached on ``prep`` so a reused
    layout uploads once (a call on another device replaces the cache)."""
    if prep._device_bufs is None or prep._device_bufs[0] != device:
        prep._device_bufs = (device, (_side_buffers(prep.u_side, device),
                                      _side_buffers(prep.i_side, device)))
    return prep._device_bufs[1]


def _make_half(k: int, implicit: bool, weighted_reg: bool,
               bf16_gather: bool = False):
    """``half(F_other, side, bufs, reg, alpha)``: one full re-solve of one
    side's factors (permuted order) from the other side's, the reference's
    ``_make_half`` in its fused mode."""

    def weights(v, m, alpha):
        if implicit:
            return (alpha * v) * m, (1.0 + alpha * v) * m
        return m, v * m

    def ridge(A, cnt, G, reg):
        # in place on the freshly computed A: adding lam to the diagonal
        # equals A + lam * I exactly, without a second (R, k, k) buffer
        if G is not None:
            A.add_(G)
        lam = reg * cnt if weighted_reg else torch.full_like(cnt, reg)
        lam = torch.where(cnt > 0, lam.clamp_min(1e-8), torch.ones_like(cnt))
        A.diagonal(dim1=1, dim2=2).add_(lam[:, None])
        return A

    def dense_equations(F, dense, G, reg, alpha):
        """The heaviest entities: two matmuls over the whole other side.

        Implicit weights accumulate in float64 and round to f32 once:
        the heaviest entities' confidences reach millions, and an f32
        sum over the whole other side (with VᵀV added) lost up to 2e-3
        of the float64 solution at ML-20M width, against 4e-5 with the
        float64 sum (PERF.md)."""
        w_cnt, w_val, cnt = dense
        n_other = F.shape[0]
        if implicit:
            F64 = F.double()
            FF = (F64[:, :, None] * F64[:, None, :]).reshape(n_other, k * k)
            A = torch.matmul((alpha * w_val).double(), FF).reshape(-1, k, k)
            A = A.add_(F64.T @ F64).float()
            b = torch.matmul((w_cnt + alpha * w_val).double(), F64).float()
            return ridge(A, cnt, None, reg), b
        FF = (F[:, :, None] * F[:, None, :]).reshape(n_other, k * k)
        A = torch.matmul(w_cnt, FF).reshape(-1, k, k)
        b = torch.matmul(w_val, F)
        return ridge(A, cnt, G, reg), b

    def seg_equations(F_g, bufs, nb, slab, G, reg, alpha):
        """Entities over the width cap span several rows: one gather_gram
        launch over all rows, one batched matmul with the slab-local
        one-hot, one index_add_ of the slab blocks at their entities."""
        oi, vv, mm, cnt, seg, slots = bufs
        wo, wb = weights(vv, mm, alpha)
        A_r, b_r = ops.gather_gram(F_g, oi, wo, wb)
        n_slabs = oi.shape[0] // slab
        Ab_r = torch.cat([A_r, b_r[:, :, None]], dim=-1)
        Ab_l = torch.einsum("nre,nrkm->nekm", seg,
                            Ab_r.reshape(n_slabs, slab, k, k + 1))
        Ab_e = torch.zeros((nb + slab, k, k + 1), dtype=torch.float32,
                           device=F_g.device)
        Ab_e.index_add_(0, slots, Ab_l.reshape(-1, k, k + 1))
        A = ridge(Ab_e[:nb, :, :k].contiguous(), cnt, G, reg)
        return A, Ab_e[:nb, :, k].contiguous()

    def half(F_other: torch.Tensor, side: _BucketSide, bufs: tuple,
             reg: float, alpha: float) -> torch.Tensor:
        dense, buckets = bufs
        # bf16 gather mode: ONE cast per half-step; the buckets gather the
        # cast copy (the dense head and the implicit Gram stay f32)
        F_g = F_other.to(torch.bfloat16) if bf16_gather else F_other
        G = F_other.T @ F_other if implicit else None
        outs, total = [], 0
        if dense is not None:
            A, b = dense_equations(F_other, dense, G, reg, alpha)
            outs.append(ops.chol_solve(A, b))
            total += side.dense.nb
        for bk, bb in zip(side.buckets, buckets):
            if bk.seg is not None:
                A, b = seg_equations(F_g, bb, bk.nb, bk.slab, G, reg, alpha)
                x = ops.chol_solve(A, b)
            else:
                oi, vv, mm, cnt = bb
                wo, wb = weights(vv, mm, alpha)
                A, b = ops.gather_gram(F_g, oi, wo, wb)
                x = ops.chol_solve(ridge(A, cnt, G, reg), b)[:bk.nb]
            outs.append(x)
            total += bk.nb
        if total < side.n:  # zero-rating tail entities → zero factors
            outs.append(torch.zeros((side.n - total, k), dtype=torch.float32,
                                    device=F_other.device))
        out = torch.cat(outs) if len(outs) > 1 else outs[0]
        return out[:side.n] if total > side.n else out

    return half


def _train_permuted(prep: ALSPrepared, p: ALSParams, bufs: tuple,
                    V0p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The iteration loop on permuted device factors, from V0p."""
    half = _make_half(p.rank, bool(p.implicit), bool(p.weighted_reg),
                      bool(p.bf16_gather))
    u_bufs, i_bufs = bufs
    # the reference passes reg and alpha as f32 scalars
    reg, alpha = float(np.float32(p.reg)), float(np.float32(p.alpha))
    if p.iterations == 0:
        # U-recovery: U from already-converged V
        return half(V0p, prep.u_side, u_bufs, reg, alpha), V0p
    U = torch.zeros((prep.n_users, p.rank), dtype=torch.float32,
                    device=V0p.device)
    V = V0p
    for _ in range(p.iterations):
        U = half(V, prep.u_side, u_bufs, reg, alpha)
        V = half(U, prep.i_side, i_bufs, reg, alpha)
    return U, V


def als_train_prepared(prep: ALSPrepared, p: ALSParams, device=None,
                       V0: Optional[np.ndarray] = None,
                       checkpointer=None, checkpoint_every: int = 0,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Train from a prepared layout on ``device`` (CUDA unless the caller
    passes ``"cpu"``); returns (U, V) in ORIGINAL entity order as numpy
    arrays. Training starts from ``init_factors(n_items, rank, seed)``, or
    from ``V0`` (original order) when given — with ``iterations=0`` that
    recovers U from converged item factors.

    With ``checkpointer`` (a ``utils/checkpoint.TrainCheckpointer``) and
    ``checkpoint_every > 0`` the iterations run in blocks of
    ``checkpoint_every``, one :func:`_train_permuted` call each, and the
    permuted U and V are saved after each block (they come to the host
    once a block). A restart with the same checkpointer restores the
    newest compatible step and runs only the remaining iterations, which
    gives the straight run's factors (V alone determines the next
    iteration); a run that died after its final save recovers without
    retraining; a checkpoint of another geometry is wiped with a
    RuntimeWarning and training starts over. The JAX package's block
    loop, on the port's checkpoint format."""
    device = resolve_device(device)
    if V0 is None:
        V0 = init_factors(prep.n_items, p.rank, p.seed)
    V0p = np.ascontiguousarray(np.asarray(V0, np.float32)[prep.i_side.perm])
    start, U0 = 0, None
    if checkpointer is not None and checkpointer.latest_step() is not None:
        from predictionio_tpu_torch.utils.checkpoint import CheckpointGeometryError

        template = {"U": np.zeros((prep.n_users, p.rank), np.float32),
                    "V": np.zeros_like(V0p)}
        try:
            state, step = checkpointer.restore_latest_compatible(template)
            V0p, U0 = state["V"], state["U"]
            start = min(int(step), p.iterations)
        except CheckpointGeometryError:
            # confirmed stale (another geometry or rank): wipe, or the
            # fresh run's lower steps stay shadowed by the stale latest
            # step. Transient read errors propagate instead.
            import warnings

            warnings.warn(
                "ALS checkpoints are stale (geometry/format change) — wiped; "
                "training restarts from scratch", RuntimeWarning)
            checkpointer.clear()

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    bufs = _device_buffers(prep, device)
    with full_f32():
        if start >= p.iterations and U0 is not None:
            # died between the final save and persistence: nothing to train
            U, V = put(U0), put(V0p)
        elif checkpointer is None or checkpoint_every <= 0 or p.iterations == 0:
            U, V = _train_permuted(
                prep, dataclasses.replace(p, iterations=p.iterations - start),
                bufs, put(V0p))
        else:
            V, it = put(V0p), start
            while it < p.iterations:
                n = min(checkpoint_every, p.iterations - it)
                U, V = _train_permuted(
                    prep, dataclasses.replace(p, iterations=n), bufs, V)
                it += n
                checkpointer.save(it, {"U": U.cpu().numpy(), "V": V.cpu().numpy()})
    # un-permute on the device and fetch U and V as one packed array
    inv_u = torch.as_tensor(prep.u_side.inv_perm.astype(np.int64)).to(device)
    inv_v = torch.as_tensor(prep.i_side.inv_perm.astype(np.int64)).to(device)
    packed = torch.cat([U.index_select(0, inv_u),
                        V.index_select(0, inv_v)]).cpu().numpy()
    return packed[:prep.n_users], packed[prep.n_users:]


def als_train(coo: RatingsCOO, params: ALSParams, device=None,
              checkpointer=None, checkpoint_every: int = 0, mesh=None,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Train ALS on ``device``; returns (U [n_users, k], V [n_items, k]).
    ``checkpointer``/``checkpoint_every``: see :func:`als_train_prepared`.

    ``mesh`` (a ``parallel/mesh.Mesh`` with a ``"data"`` axis) of more
    than one slot trains sharded over it
    (:func:`models.als_sharded.als_train_sharded`); a one-slot mesh runs
    the single-device path on that slot's device."""
    if mesh is not None and mesh.size > 1:
        from predictionio_tpu_torch.models.als_sharded import als_train_sharded

        return als_train_sharded(coo, params, mesh, checkpointer=checkpointer,
                                 checkpoint_every=checkpoint_every)
    if mesh is not None:
        device = mesh.slots[0]
    return als_train_prepared(als_prepare(coo), params, device=device,
                              checkpointer=checkpointer,
                              checkpoint_every=checkpoint_every)


def als_train_many(coo: RatingsCOO, params_list, device=None, mesh=None) -> list:
    """Train one (U, V) per params on the SAME ratings — the ``pio eval``
    grid fan-out — on ``device`` (CUDA unless the caller passes "cpu").
    The host layout is prepared ONCE and uploaded once (the upload is
    cached on the layout, ``_device_buffers``); each candidate then runs
    the same half-steps as ``pio train``, one after another. ``mesh``
    dispatches as in :func:`als_train`: sharded over more than one slot,
    else on the one slot's device."""
    params_list = list(params_list)
    if mesh is not None and mesh.size > 1:
        from predictionio_tpu_torch.models.als_sharded import (
            als_prepare_sharded,
            als_train_sharded_prepared,
        )

        sprep = als_prepare_sharded(coo, mesh.size)
        return [als_train_sharded_prepared(sprep, p, mesh) for p in params_list]
    device = resolve_device(mesh.slots[0] if mesh is not None else device)
    prep = als_prepare(coo)
    return [als_train_prepared(prep, p, device=device) for p in params_list]


def als_train_scored(prep: ALSPrepared, p0: ALSParams):
    """The per-candidate train+score program of the distributed sweep
    (``core/sweep.py``): ``one(hyper, u_bufs, i_bufs, V0p, uq, iq, rq,
    valid) -> (sq_err_sum, valid_count)``, two tensors on the device,
    with ``hyper = [reg, alpha]`` one float32 row of the stacked grid
    (the rest of the params are ``p0``'s).

    Training is :func:`_train_permuted`'s (a zero U0, then ``iterations``
    pairs of half-steps through the ``gather_gram`` and ``chol_solve``
    kernels); the held-out fold is scored on the device: ``uq``/``iq``
    index PERMUTED factor rows, ``valid`` masks cold pairs (NegRMSE's
    skip-empty-prediction convention), so a candidate with no warm pair
    returns count 0 (NaN downstream, ranked last). ``prep`` gives only the
    layout's structure, which the sweep's geometry key holds, so one
    program serves every layout of the same geometry."""

    def one(hyper, u_bufs, i_bufs, V0p, uq, iq, rq, valid):
        p = dataclasses.replace(p0, reg=float(hyper[0]), alpha=float(hyper[1]))
        with full_f32():
            U, V = _train_permuted(prep, p, (u_bufs, i_bufs), V0p)
        pred = (U[uq] * V[iq]).sum(-1)
        err = torch.where(valid, (pred - rq) ** 2, torch.zeros_like(pred))
        return err.sum(), valid.to(torch.float32).sum()

    return one


def als_sweep_program(prep: ALSPrepared, p0: ALSParams, users: np.ndarray,
                      items: np.ndarray, ratings: np.ndarray,
                      valid: np.ndarray, device=None):
    """The ``(geometry, build, data)`` triple core/sweep.py's SweepProgram
    wants for a bucket of ALS candidates sharing rank, iterations,
    implicit, weighted_reg, bf16_gather, seed and the prepared layout, on
    ``device`` (CUDA unless the caller passes "cpu"). ``users``/``items``
    are fold-local dense entity ids (cold pairs carry any in-range id
    with ``valid`` False); they are mapped to permuted factor positions
    HERE so the program gathers directly. ``data`` lives on the device:
    the layout (uploaded once, cached on ``prep``), V0 in permuted order
    and the held-out fold."""
    device = resolve_device(device)
    geometry = ("als_scored", prep.u_side.geometry, prep.i_side.geometry,
                prep.n_users, prep.n_items, int(p0.rank),
                int(p0.iterations), bool(p0.implicit),
                bool(p0.weighted_reg), str(device), bool(p0.bf16_gather),
                int(p0.seed), len(users))
    u_bufs, i_bufs = _device_buffers(prep, device)

    def put(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

    V0p = init_factors(prep.n_items, p0.rank, p0.seed)[prep.i_side.perm]
    uq = prep.u_side.inv_perm[np.asarray(users, np.int64)].astype(np.int64)
    iq = prep.i_side.inv_perm[np.asarray(items, np.int64)].astype(np.int64)
    data = (u_bufs, i_bufs, put(V0p, np.float32), put(uq), put(iq),
            put(ratings, np.float32), put(valid, bool))

    return geometry, lambda: als_train_scored(prep, p0), data


# -- scoring ------------------------------------------------------------------


def predict_ratings(U: np.ndarray, V: np.ndarray, users: np.ndarray,
                    items: np.ndarray) -> np.ndarray:
    """r̂ for (user, item) pairs."""
    return np.einsum("nk,nk->n", U[users], V[items])


def recommend(
    U: np.ndarray, V: np.ndarray, user: int, num: int,
    exclude: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-``num`` items for one user → (item_indices, scores)."""
    scores = V @ U[user]
    if exclude is not None and exclude.size:
        scores = scores.copy()
        scores[exclude] = -np.inf
    num = min(num, scores.shape[0])
    top = np.argpartition(-scores, num - 1)[:num]
    top = top[np.argsort(-scores[top])]
    return top, scores[top]


def similar_items(
    V: np.ndarray, item_indices: np.ndarray, num: int,
    exclude_self: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-``num`` items by cosine similarity to the given items' mean
    direction (similar-product template behavior), on the host."""
    norms = np.linalg.norm(V, axis=1, keepdims=True)
    Vn = V / np.maximum(norms, 1e-12)
    q = Vn[item_indices].mean(axis=0)
    qn = q / max(np.linalg.norm(q), 1e-12)
    scores = Vn @ qn
    if exclude_self:
        scores = scores.copy()
        scores[item_indices] = -np.inf
    num = min(num, scores.shape[0])
    top = np.argpartition(-scores, num - 1)[:num]
    top = top[np.argsort(-scores[top])]
    return top, scores[top]


def normalized_rows(V: np.ndarray) -> np.ndarray:
    """V's rows scaled to unit length (a zero row stays zero): the item
    factors cosine similarity scores against."""
    V = np.asarray(V, np.float32)
    return V / np.maximum(np.linalg.norm(V, axis=1, keepdims=True), 1e-12)


def similar_items_device(scorer: "ResidentScorer", Vn: np.ndarray,
                         item_indices: np.ndarray, num: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`similar_items`'s answer from a :class:`ResidentScorer`
    built on the normalised factors (``ResidentScorer(Vn, Vn)``,
    ``Vn = normalized_rows(V)``): ONE ``score_topk`` launch of the query
    items' normalised mean direction against the resident rows, the
    query items left out (and appended at -inf, in index order, only
    when the rest of the catalog cannot fill ``num``)."""
    idx = np.asarray(item_indices, np.int64)
    q = Vn[idx].mean(axis=0)
    qn = (q / max(np.linalg.norm(q), 1e-12)).astype(np.float32)
    excl = np.unique(idx)
    num = min(num, scorer.n_items)
    top, vals = scorer.recommend_vector(qn, num, exclude=excl)
    if top.size < num:
        fill = excl[:num - top.size]
        top = np.concatenate([top, fill])
        vals = np.concatenate([vals, np.full(fill.size, -np.inf, np.float32)])
    return top, vals


def _gather_score_topk(U: torch.Tensor, Vp: torch.Tensor, ids: torch.Tensor,
                       *, k: int, n_valid: int, rows_valid: int,
                       out: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """The serving program: gather the batch's user rows, score them
    against every item and keep the top k, into ``out``. Every k the
    kernel takes goes through it; above :data:`ops.MAX_K` the port
    follows the JAX package's dense path (a matmul, then a stable
    descending sort)."""
    if k <= ops.MAX_K:
        ops.score_topk(U, Vp, k, n_valid=n_valid, rows_valid=rows_valid,
                       ids=ids, out=out)
        return
    vals, idx = ops.score_topk_ref(U, Vp, k, n_valid=n_valid,
                                   rows_valid=rows_valid, ids=ids)
    out[0].copy_(vals)
    out[1].copy_(idx)


def _bucket_k(want: int) -> int:
    """Serving k bucketed to powers of two from 16 (bounds the set of
    warmed programs; shared by the hot path and the AOT warmup so they
    agree on which programs exist)."""
    k = 16
    while k < want:
        k *= 2
    return k


_SERVE_MIN_ITEMS = 2048


def serve_on_device(n_items: int) -> bool:
    """The device-vs-host serving policy: device-resident serving for
    production-size catalogs (≥ ``_SERVE_MIN_ITEMS`` items), host numpy
    below that, where a matvec beats a device dispatch.
    ``PIO_ALS_SERVE`` overrides: "host" forces the host path, "device"
    forces a scorer."""
    mode = os.environ.get("PIO_ALS_SERVE", "auto")
    if mode == "host":
        return False
    return mode != "auto" or n_items >= _SERVE_MIN_ITEMS


def maybe_resident_scorer(U, V, cached=None, device=None):
    """A lazy device-resident :class:`ResidentScorer` when
    :func:`serve_on_device` says so, else None (→ host numpy scoring).
    A cached scorer is reused only if it was built from these exact U/V
    arrays on this device, so a factor swap never serves stale scores."""
    if not serve_on_device(V.shape[0]):
        return None
    if cached is not None and cached.built_from(U, V, device):
        return cached
    return ResidentScorer(U, V, device=device)


def serve_topk_batch(scorer, user_ids, item_inv, queries, fallback,
                     per_query=None):
    """Serve a micro-batch of top-k queries in ONE device dispatch.

    Collect every top-k-shaped query, score them all through
    ``scorer.recommend_batch`` with a single padded ``k = max(num)``,
    slice per row. Queries ``per_query`` flags (e.g. rating-prediction
    shapes) and unknown users are answered without touching the device;
    ``scorer=None`` (host-path catalogs) serves everything via
    ``fallback``. AOT-bucket ``PAD`` sentinels are never served: their
    slots stay None and the batcher slices them off.

    ``user_ids``: str id → row index mapping (``.get``); ``item_inv``:
    row index → item id; ``fallback``: per-query callable returning a
    response dict.
    """
    from predictionio_tpu_torch.server.aot import PAD

    if scorer is None:
        return [None if q is PAD else fallback(q) for q in queries]
    out = [None] * len(queries)
    rows = []  # (out index, user row, num)
    for i, q in enumerate(queries):
        if q is PAD:
            continue
        if per_query is not None and per_query(q):
            out[i] = fallback(q)
            continue
        uidx = user_ids.get(str(q["user"]))
        if uidx is None:
            out[i] = {"itemScores": []}
            continue
        rows.append((i, uidx, int(q.get("num", 10))))
    if rows:
        k = max(n for _, _, n in rows)
        res = scorer.recommend_batch(
            np.asarray([u for _, u, _ in rows], np.int32), k)
        for (i, _, n), (iv, vv) in zip(rows, res):
            out[i] = {"itemScores": [
                {"item": item_inv[int(j)], "score": float(s)}
                for j, s in zip(iv[:n], vv[:n])]}
    return out


class _ServeProgram:
    """One warmed serving program for a (batch bucket B, k) pair: the
    device ids buffer, the (B, k) outputs and the host result buffers
    (pinned on the card) are allocated once. Calls are serialized, since
    the buffers are reused; they hold no model values, so one program
    serves every scorer of the same geometry."""

    def __init__(self, device: torch.device, B: int, k: int) -> None:
        self.device, self.B, self.k = device, B, k
        self._lock = threading.Lock()
        pin = device.type == "cuda"
        self._ids = torch.empty(B, dtype=torch.int32, device=device)
        self._vals = torch.empty((B, k), dtype=torch.float32, device=device)
        self._idx = torch.empty((B, k), dtype=torch.int32, device=device)
        self._ids_host = torch.empty(B, dtype=torch.int32, pin_memory=pin)
        self._vals_host = torch.empty((B, k), dtype=torch.float32, pin_memory=pin)
        self._idx_host = torch.empty((B, k), dtype=torch.int32, pin_memory=pin)

    def __call__(self, scorer: "ResidentScorer", user_ids: np.ndarray,
                 rows_valid: int) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            self._ids_host.numpy()[:] = user_ids
            self._ids.copy_(self._ids_host, non_blocking=True)
            _gather_score_topk(scorer._U, scorer._V_padded, self._ids,
                               k=self.k, n_valid=scorer.n_items,
                               rows_valid=rows_valid,
                               out=(self._vals, self._idx))
            self._vals_host.copy_(self._vals, non_blocking=True)
            self._idx_host.copy_(self._idx, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            return self._vals_host.numpy().copy(), self._idx_host.numpy().copy()


class LadderScorer:
    """The serving contract of the device-resident scorers (the exact
    :class:`ResidentScorer` and the ANN package's ``ANNScorer``): the
    host arrays a scorer was built from, the AOT bucket ladder and its
    warmed (B, k) programs, one dispatch with its span and latency
    label, and ``recommend_batch``'s batch/k bucketing, pad rows and
    host-side exclusion. ``AOTWarmup``, the micro-batcher and
    :func:`serve_topk_batch` rely on nothing else.

    A subclass names its program class (``_program``, built as
    ``_program(device, B, k)`` and called as ``prog(scorer, ids,
    rows_valid)`` → (vals, idx) on the host), its cache key
    (``_aot_key``), the label of a warmed dispatch (``_path``), and may
    clamp serving k further (``_serving_k``). ``device`` defaults to
    CUDA and raises when there is no card.
    """

    _program: type
    _path = "aot"

    def __init__(self, U, V, device=None) -> None:
        self.device = resolve_device(device)
        # weak identity of the host arrays this scorer was built from,
        # so the maybe_*_scorer helpers can detect a factor swap
        # (weakref, not id(): a freed array's address can be recycled)
        try:
            self._source = (weakref.ref(U), weakref.ref(V))
        except TypeError:  # non-weakref-able array-likes (e.g. lists)
            self._source = None
        self.n_users, self.rank = U.shape
        self.n_items = V.shape[0]
        if self.n_items >= 1 << 24:
            # the JAX package's scorers pack indices into f32 and take
            # only catalogs below 2^24; both packages accept the same ones
            raise ValueError(
                f"{type(self).__name__} supports catalogs < 2^24 items")
        #: AOT-bucket serving state (server/aot): when a ladder is set,
        #: batch sizes snap to it and warmed buckets run a warmed program
        self.bucket_ladder = None
        self._aot: dict = {}   # (B, k) -> program

    def built_from(self, U, V, device=None) -> bool:
        """True iff this scorer was built from exactly these host arrays
        on the device ``device`` resolves to."""
        if self._source is None:
            return False
        return (self._source[0]() is U and self._source[1]() is V
                and torch.device("cuda" if device is None else device).type
                == self.device.type)

    # -- AOT bucket ladder (server/aot) ---------------------------------------

    def set_bucket_ladder(self, ladder) -> None:
        """Snap serving batch sizes to ``ladder`` (a
        ``server/aot.BucketLadder``) instead of the power-of-two rule."""
        self.bucket_ladder = ladder

    def _serving_k(self, want: int) -> int:
        """Serving k: bucketed to powers of two (bounds the warmed
        programs), never beyond the catalog."""
        return min(_bucket_k(want), self.n_items)

    def _aot_key(self, B: int, k: int) -> tuple:
        raise NotImplementedError

    def _ensure_executable(self, B: int, k: int) -> bool:
        """Warm the serving program for one (batch bucket, k) pair via
        the process-wide cache: allocate its buffers and run it once
        (which builds the kernel library on first use). Returns True if
        this call warmed it (False = cache hit)."""
        from predictionio_tpu_torch.server.aot import EXECUTABLES

        key = self._aot_key(B, k)
        was_cold = EXECUTABLES.get(key) is None

        def build():
            prog = self._program(self.device, B, k)
            prog(self, np.zeros(B, np.int32), B)
            return prog

        self._aot[(B, k)] = EXECUTABLES.get_or_compile(key, build)
        return was_cold

    def warm_buckets(self, ladder, ks=(16,)) -> dict:
        """Deploy-time warmup: warm (or adopt from the process-wide
        cache) one program per (bucket, k); adopts ``ladder`` as this
        scorer's serving ladder."""
        self.set_bucket_ladder(ladder)
        compiled = cached = 0
        for B in ladder:
            for k in ks:
                if self._ensure_executable(B, self._serving_k(k)):
                    compiled += 1
                else:
                    cached += 1
        return {"targets": compiled + cached,
                "compiled": compiled, "cached": cached}

    def _topk(self, user_ids: np.ndarray, k: int, rows: Optional[int] = None):
        """One serving dispatch at an (already bucket-padded) batch.
        ``rows`` = real row count (pad rows masked on device). Warmed
        buckets run their warmed program under ``_path``; any other
        shape builds a one-off program (counted as path "jit", the JAX
        package's label for the same warmup gap)."""
        from predictionio_tpu_torch.server import aot
        from predictionio_tpu_torch.utils import tracing

        B = len(user_ids)
        rows_valid = B if rows is None else int(rows)
        prog = self._aot.get((B, k))
        path = self._path if prog is not None else "jit"
        with tracing.span("serving.device", bucket=B, k=k, path=path):
            t0 = time.perf_counter()
            if prog is None:
                prog = self._program(self.device, B, k)
            out = prog(self, np.asarray(user_ids, np.int32), rows_valid)
            aot.record_device_latency(B, time.perf_counter() - t0, path,
                                      trace_exemplar=tracing.exemplar())
        return out

    def recommend_batch(self, user_ids: np.ndarray, num: int,
                        exclude: Optional[list] = None) -> list:
        """Top-``num`` per user → list of (item_indices, scores) pairs.

        ``exclude[i]`` is an optional array of item indices to drop for
        user i; ``exclude`` itself or any entry may be None/empty.
        """
        user_ids = np.asarray(user_ids, np.int64)
        if user_ids.size and (user_ids.min() < 0 or user_ids.max() >= self.n_users):
            raise ValueError(f"user rows outside 0..{self.n_users - 1}")
        if not exclude:
            exclude = [None] * len(user_ids)
        exclude = [np.asarray([] if e is None else e, np.int32)
                   for e in exclude]
        max_ex = max((e.size for e in exclude), default=0)
        # over-fetch for exclusions but never more than the catalog
        want = min(num + max_ex, self.n_items)
        k = self._serving_k(want)
        # bucket the BATCH dimension too: with an AOT ladder set, batches
        # snap to ITS buckets so every dispatch hits a warmed program;
        # pad rows reuse user 0, are masked on device, and are sliced off
        B = len(user_ids)
        Bp = (self.bucket_ladder.snap(B)
              if self.bucket_ladder is not None else 0)
        if Bp < B:  # no ladder, or batch beyond its top bucket
            Bp = 1
            while Bp < B:
                Bp *= 2
        ids = user_ids.astype(np.int32)
        if Bp != B:
            ids = np.concatenate([ids, np.zeros(Bp - B, np.int32)])
        vals, idx = self._topk(ids, k, rows=B)
        vals, idx = vals[:B], idx[:B]
        out = []
        for row in range(B):
            iv, vv = idx[row], vals[row]
            if exclude[row].size:
                keep = ~np.isin(iv, exclude[row])
                iv, vv = iv[keep], vv[keep]
            out.append((iv[:num], vv[:num]))
        return out

    def recommend(self, user: int, num: int,
                  exclude: Optional[np.ndarray] = None):
        [(iv, vv)] = self.recommend_batch(
            np.asarray([user]), num,
            [np.asarray(exclude if exclude is not None else [], np.int32)])
        return iv, vv


class ResidentScorer(LadderScorer):
    """Serving-time scorer with factors resident on the device.

    U and V live in device memory across requests; each batch is one
    gather → score → top-k program (the ``score_topk`` kernel on the
    card, its plain version on the CPU). Exclusions are handled by
    over-fetching a padded k (bucketed to bound the warmed programs) and
    filtering host-side. ``device`` defaults to CUDA and raises when
    there is no card.
    """

    _TILE = 2048  # item padding of the resident V
    _program = _ServeProgram

    def __init__(self, U: np.ndarray, V: np.ndarray, device=None):
        super().__init__(U, V, device)
        self._U = torch.as_tensor(np.asarray(U, np.float32)).to(self.device)
        # ONE resident copy, padded once at load to the tile; the kernel
        # masks the pad rows through n_valid
        pad = -self.n_items % self._TILE
        Vp = np.asarray(V, np.float32)
        if pad:
            Vp = np.concatenate([Vp, np.zeros((pad, self.rank), np.float32)])
        self._V_padded = torch.as_tensor(Vp).to(self.device)

    def _aot_key(self, B: int, k: int) -> tuple:
        return ("gather_score_topk", self.n_users, self.rank,
                int(self._V_padded.shape[0]), self.n_items, B, k,
                str(self.device))

    def recommend_vector(self, q: np.ndarray, num: int,
                         exclude: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``num`` items for a query vector ``q`` (shape (d,)) in
        place of a row of U: one launch of (1, d) against the resident
        V, k bucketed and over-fetched for ``exclude`` as in
        :meth:`recommend_batch`."""
        excl = np.asarray([] if exclude is None else exclude, np.int64)
        num = min(num, self.n_items)
        k = min(_bucket_k(num + excl.size), self.n_items)
        Q = torch.as_tensor(np.asarray(q, np.float32).reshape(1, self.rank)).to(self.device)
        out = (torch.empty((1, k), dtype=torch.float32, device=self.device),
               torch.empty((1, k), dtype=torch.int32, device=self.device))
        _gather_score_topk(Q, self._V_padded, torch.zeros(1, dtype=torch.int32,
                                                          device=self.device),
                           k=k, n_valid=self.n_items, rows_valid=1, out=out)
        vals, top = out[0][0].cpu().numpy(), out[1][0].cpu().numpy().astype(np.int64)
        keep = ~np.isin(top, excl)
        return top[keep][:num], vals[keep][:num]
