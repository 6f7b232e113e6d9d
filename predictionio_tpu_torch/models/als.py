"""Alternating Least Squares: the serving half.

Recommendation serving keeps the factor matrices resident on the card
and answers each micro-batch with one gather → score → top-k launch of
the hand-written ``score_topk`` kernel (``ops/topk.py``). Training (the
fused gather→Gram and batched Cholesky kernels) is the next slice of the
port; this module holds what deploy needs:

- :func:`init_factors` — the deterministic host-side factor init shared
  with the JAX package (same numpy draws, so seeded factors agree);
- :func:`predict_ratings`, :func:`recommend` — host numpy scoring for
  small catalogs;
- :class:`ResidentScorer` — U and tile-padded V resident on the device,
  batches padded to the AOT bucket ladder, exclusions over-fetched;
- :func:`serve_on_device`, :func:`maybe_resident_scorer`,
  :func:`serve_topk_batch` — the serving policy the templates share.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch import ops
from predictionio_tpu_torch.utils.device import resolve_device


def init_factors(n: int, rank: int, seed: int) -> np.ndarray:
    """Deterministic host-side factor init (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, rank)) / np.sqrt(rank)).astype(np.float32)


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

    def __call__(self, U: torch.Tensor, Vp: torch.Tensor, n_valid: int,
                 user_ids: np.ndarray, rows_valid: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            self._ids_host.numpy()[:] = user_ids
            self._ids.copy_(self._ids_host, non_blocking=True)
            _gather_score_topk(U, Vp, self._ids, k=self.k, n_valid=n_valid,
                               rows_valid=rows_valid,
                               out=(self._vals, self._idx))
            self._vals_host.copy_(self._vals, non_blocking=True)
            self._idx_host.copy_(self._idx, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            return self._vals_host.numpy().copy(), self._idx_host.numpy().copy()


class ResidentScorer:
    """Serving-time scorer with factors resident on the device.

    U and V live in device memory across requests; each batch is one
    gather → score → top-k program (the ``score_topk`` kernel on the
    card, its plain version on the CPU). Exclusions are handled by
    over-fetching a padded k (bucketed to bound the warmed programs) and
    filtering host-side. ``device`` defaults to CUDA and raises when
    there is no card.
    """

    _TILE = 2048  # item padding of the resident V

    def __init__(self, U: np.ndarray, V: np.ndarray, device=None):
        self.device = resolve_device(device)
        # weak identity of the host arrays this scorer was built from,
        # so maybe_resident_scorer can detect a factor swap (weakref,
        # not id(): a freed array's address can be recycled)
        try:
            self._source = (weakref.ref(U), weakref.ref(V))
        except TypeError:  # non-weakref-able array-likes (e.g. lists)
            self._source = None
        self.n_users, self.rank = U.shape
        self.n_items = V.shape[0]
        if self.n_items >= 1 << 24:
            # the JAX package's scorer packs indices into f32 and takes
            # only catalogs below 2^24; both packages accept the same ones
            raise ValueError("ResidentScorer supports catalogs < 2^24 items")
        self._U = torch.as_tensor(np.asarray(U, np.float32)).to(self.device)
        # ONE resident copy, padded once at load to the tile; the kernel
        # masks the pad rows through n_valid
        pad = -self.n_items % self._TILE
        Vp = np.asarray(V, np.float32)
        if pad:
            Vp = np.concatenate([Vp, np.zeros((pad, self.rank), np.float32)])
        self._V_padded = torch.as_tensor(Vp).to(self.device)
        #: AOT-bucket serving state (server/aot): when a ladder is set,
        #: batch sizes snap to it and warmed buckets run a warmed program
        self.bucket_ladder = None
        self._aot: dict = {}   # (B, k) -> _ServeProgram

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

    def _aot_key(self, B: int, k: int) -> tuple:
        return ("gather_score_topk", self.n_users, self.rank,
                int(self._V_padded.shape[0]), self.n_items, B, k,
                str(self.device))

    def _ensure_executable(self, B: int, k: int) -> bool:
        """Warm the serving program for one (batch bucket, k) pair via
        the process-wide cache: allocate its buffers and run it once
        (which builds the kernel library on first use). Returns True if
        this call warmed it (False = cache hit)."""
        from predictionio_tpu_torch.server.aot import EXECUTABLES

        key = self._aot_key(B, k)
        was_cold = EXECUTABLES.get(key) is None

        def build():
            prog = _ServeProgram(self.device, B, k)
            prog(self._U, self._V_padded, self.n_items,
                 np.zeros(B, np.int32), B)
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
                kk = min(_bucket_k(k), self.n_items)
                if self._ensure_executable(B, kk):
                    compiled += 1
                else:
                    cached += 1
        return {"targets": compiled + cached,
                "compiled": compiled, "cached": cached}

    def _topk(self, user_ids: np.ndarray, k: int, rows: Optional[int] = None):
        """One serving dispatch at an (already bucket-padded) batch.
        ``rows`` = real row count (pad rows masked on device). Warmed
        buckets run their warmed program; any other shape builds a
        one-off program (counted as path "eager" — a warmup gap)."""
        from predictionio_tpu_torch.server import aot
        from predictionio_tpu_torch.utils import tracing

        B = len(user_ids)
        rows_valid = B if rows is None else int(rows)
        prog = self._aot.get((B, k))
        path = "aot" if prog is not None else "eager"
        with tracing.span("serving.device", bucket=B, k=k, path=path):
            t0 = time.perf_counter()
            if prog is None:
                prog = _ServeProgram(self.device, B, k)
            out = prog(self._U, self._V_padded, self.n_items,
                       np.asarray(user_ids, np.int32), rows_valid)
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
        # bucket k to powers of two (bounds the warmed programs);
        # over-fetch for exclusions but never more than the catalog
        want = min(num + max_ex, self.n_items)
        k = min(_bucket_k(want), self.n_items)
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
