"""Device-resident ANN serving: ADC scan → shortlist → re-rank.

The serving half of the ANN subsystem, the port's copy of the JAX
package's ``ann/scorer.py``. It shares the exact path's serving
contract (:class:`predictionio_tpu_torch.models.als.LadderScorer`) — the
same AOT bucket-ladder warm-up, the same single fetch, the same pad-row
masking — so :class:`~predictionio_tpu_torch.server.aot.AOTWarmup`,
the micro-batcher and ``serve_topk_batch`` work unchanged; a template
swaps scorers, nothing above it moves.

One serving dispatch runs, as one program per (bucket, k):

    Q = U[user_ids]                   (gather query embeddings)
    LUT = Q_sub · codebooks           ((m, B, K) inner-product tables)
    adc = Σ_m LUT[m, b, code[m, n]]   ((B, N) approximate scores, tiled)
    shortlist = top_k'(adc)           ((B, k′) candidate rows)
    exact = Q · V[shortlist]          (float re-rank, gathered rows only)
    out = top_k(exact) packed as [vals ++ idx as f32]

It launches no ``score_topk``: the ADC math is plain PyTorch
(``ops/topk.adc_shortlist`` and ``rerank_topk``). Device latency records
under ``path="ann"`` (the exact path's is ``"aot"``); a dispatch at an
unwarmed shape records ``"jit"``, the JAX package's label for the same
warm-up gap.

The mesh-sharded scorer is not ported (ROADMAP.md queue 1, item 8b): a
shard count above 1, from the caller, ``PIO_ANN_SHARDS`` or the index
blob's hint, raises instead of serving unsharded.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from predictionio_tpu_torch.ann.index import PQIndex
from predictionio_tpu_torch.models.als import (
    LadderScorer, _bucket_k, serve_on_device)

DEFAULT_SHORTLIST = 128

SHARDED_NOT_PORTED = (
    "sharded ANN serving (ShardedANNScorer) is not ported to "
    "predictionio_tpu_torch yet (ROADMAP.md queue 1, item 8b)")


class _ANNProgram:
    """One warmed serving program for a (batch bucket B, k) pair: the
    device ids buffer and the packed (B, 2k) output, with their pinned
    host twins on the card, are allocated once. Calls are serialized,
    since the buffers are reused; they hold no model values, so one
    program serves every scorer of the same geometry."""

    def __init__(self, device, B: int, k: int) -> None:
        import torch

        self.device, self.B, self.k = device, B, k
        self._lock = threading.Lock()
        pin = device.type == "cuda"
        self._ids = torch.empty(B, dtype=torch.int32, device=device)
        self._packed = torch.empty((B, 2 * k), dtype=torch.float32, device=device)
        self._ids_host = torch.empty(B, dtype=torch.int32, pin_memory=pin)
        self._packed_host = torch.empty((B, 2 * k), dtype=torch.float32,
                                        pin_memory=pin)
        self._rows = torch.arange(B, device=device)[:, None]

    def __call__(self, scorer: "ANNScorer", user_ids: np.ndarray,
                 rows_valid: int):
        import torch

        from predictionio_tpu_torch.ops.topk import adc_shortlist, rerank_topk

        k = self.k
        with self._lock:
            self._ids_host.numpy()[:] = user_ids
            self._ids.copy_(self._ids_host, non_blocking=True)
            Q = scorer._U.index_select(0, self._ids)
            Q = torch.where(self._rows < rows_valid, Q, torch.zeros_like(Q))
            Qr = Q if scorer._rot is None else Q @ scorer._rot
            _svals, sidx = adc_shortlist(Qr, scorer._codebooks, scorer._codesT,
                                         scorer.shortlist)
            vals, idx = rerank_topk(Q, scorer._V, sidx, k)
            # ONE packed output, one fetch a batch (indices exact in f32
            # below 2^24)
            self._packed[:, :k] = vals
            self._packed[:, k:] = idx.to(torch.float32)
            self._packed_host.copy_(self._packed, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            packed = self._packed_host.numpy().copy()
        return packed[:, :k], packed[:, k:].astype(np.int32)


class ANNScorer(LadderScorer):
    """Serving-time ANN scorer: PQ codes + codebooks + the float corpus
    resident on the device, one program per query batch.

    The ``ResidentScorer`` contract (``LadderScorer``: ``recommend_batch``,
    ``recommend``, ``warm_buckets``, ``set_bucket_ladder``,
    ``built_from``), so ``maybe_*_scorer`` callers, ``serve_topk_batch``
    and the AOT warm-up treat the two interchangeably. Serving k is
    clamped to the shortlist as well (over-asking an ANN index cannot
    improve recall). ``device`` defaults to CUDA and raises when there
    is no card.
    """

    _program = _ANNProgram
    _path = "ann"

    def __init__(self, U: np.ndarray, V: np.ndarray, index: PQIndex,
                 shortlist: int = DEFAULT_SHORTLIST, device=None):
        super().__init__(U, V, device)
        if index.n_items != self.n_items:
            raise ValueError(
                f"index covers {index.n_items} items, corpus has "
                f"{self.n_items}")
        if index.dim != self.rank:
            raise ValueError(
                f"index dim {index.dim} != embedding dim {self.rank}")
        self.m, self.K = index.m, index.k
        #: the shortlist the caller asked for (pre-clamp) — what
        #: ``maybe_ann_scorer`` compares for cached reuse
        self._want_shortlist = int(shortlist)
        #: shortlist size k′ — the recall/latency knob (clamped to the
        #: catalog; serving k is further clamped to k′)
        self.shortlist = max(1, min(int(shortlist), self.n_items))
        self._place(U, V, index)

    def _place(self, U, V, index: PQIndex) -> None:
        """Device placement of the serving state."""
        import torch

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        self._U = put(U, np.float32)
        # float corpus resident for the exact re-rank; UNPADDED — the
        # re-rank gathers only shortlist rows, never scans V
        self._V = put(V, np.float32)
        self._codebooks = put(index.codebooks, np.float32)
        # (m, N) uint8, subspace-major: each ADC step reads one
        # contiguous row
        self._codesT = put(np.asarray(index.codes, np.uint8).T, np.uint8)
        # OPQ rotation (None for plain-PQ / version-1 blobs)
        self._rot = (None if index.rotation is None
                     else put(index.rotation, np.float32))

    def _serving_k(self, want: int) -> int:
        """Bucketed serving k, never beyond the shortlist (the re-rank
        can only return k′ rows) or the catalog."""
        return min(_bucket_k(want), self.shortlist, self.n_items)

    def _aot_key(self, B: int, k: int) -> tuple:
        return ("ann_adc_topk", self.n_users, self.rank, self.m, self.K,
                self.n_items, B, k, self.shortlist, self._rot is not None,
                str(self.device))


class ShardedANNScorer(ANNScorer):
    """The JAX package's mesh-sharded ANN scorer, by name only: the port
    has no item-sharded serving yet, so constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise ValueError(SHARDED_NOT_PORTED)


def _resolve_shards(index: PQIndex, shards: int) -> int:
    """Shard-count resolution: ``PIO_ANN_SHARDS`` env beats the
    explicit argument beats the index blob's ``shards`` build hint."""
    env = os.environ.get("PIO_ANN_SHARDS", "").strip()
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    if shards:
        return int(shards)
    try:
        return int((index.meta or {}).get("shards") or 0)
    except (TypeError, ValueError):
        return 0


def maybe_ann_scorer(U, V, index: Optional[PQIndex], cached=None,
                     shortlist: int = DEFAULT_SHORTLIST,
                     shards: int = 0, device=None):
    """ANN twin of ``als.maybe_resident_scorer``: None (→ caller's
    exact/host path) when there is no index or the catalog is below
    ``_SERVE_MIN_ITEMS`` in auto mode; honors the same
    ``PIO_ALS_SERVE`` override and reuses ``cached`` only when built
    from these exact U/V arrays on this device with this shortlist.

    ``shards > 1`` (explicit, ``PIO_ANN_SHARDS``, or the index blob's
    build hint) raises: the sharded scorer is not ported.
    """
    if index is None:
        return None
    if not serve_on_device(V.shape[0]):
        return None
    want = _resolve_shards(index, shards)
    if want > 1:
        raise ValueError(f"{want} ANN shards asked for: {SHARDED_NOT_PORTED}; "
                         "serve with one shard (annShards 0, PIO_ANN_SHARDS unset)")
    if (cached is not None and type(cached) is ANNScorer
            and cached.built_from(U, V, device)
            and cached._want_shortlist == int(shortlist)):
        return cached
    return ANNScorer(U, V, index, shortlist=shortlist, device=device)


def load_blob_index(d: dict, instance_dir: Optional[str], shards: int):
    """A template blob dict's PQ index: ``ann_index.bin`` in
    ``instance_dir`` when there is one (sidecar and payload digests
    verified), else the blob's own bytes (payload digest verified), else
    None. Any mismatch raises
    ``IntegrityError``, which ``/reload`` turns into a refused candidate.
    An index whose serving shard count (``shards``, ``PIO_ANN_SHARDS``
    or its own hint) is above 1 raises: sharded serving is not ported."""
    from predictionio_tpu_torch.ann.index import load_index

    index = load_index(instance_dir) if instance_dir else None
    if index is None and d.get("ann_index") is not None:
        index = PQIndex.from_bytes(d["ann_index"])
    if index is not None and _resolve_shards(index, shards) > 1:
        raise ValueError(f"{_resolve_shards(index, shards)} ANN shards: "
                         f"{SHARDED_NOT_PORTED}")
    return index

