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

:class:`ShardedANNScorer` partitions the corpus item-wise over the
slots of a ``"shards"`` mesh axis (``parallel/mesh``): each slot holds
``local_n`` rows of the PQ codes and of the float corpus, and one
dispatch runs the per-slot scan at the slot's global column offset, the
gather of the per-slot shortlists onto the first slot, their merge, each
slot's share of the exact re-rank and their sum, in slot order. Its
answers are the unsharded scorer's (every global winner wins its own
slot under the key order of ``ops/topk``).
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


class _ShardedANNProgram(_ANNProgram):
    """One warmed sharded serving program for a (B, k) pair: the
    :class:`_ANNProgram` buffers on the first slot, where the queries are
    gathered and the result packed. A dispatch:

    - Q = U[ids] (pad rows zeroed), copied to every slot (the queries
      replicate);
    - each slot's ADC shortlist over its codes at its global offset,
      pad columns past the corpus tail at ``_NEG``;
    - the shortlists gathered onto the first slot and merged
      (``ops/topk.merge_shortlists``), the merged list copied back;
    - each slot's share of the exact re-rank (``rerank_partial``),
      summed onto the first slot in slot order; a pad candidate
      re-masked to ``_NEG``; the top k."""

    def __call__(self, scorer: "ShardedANNScorer", user_ids: np.ndarray,
                 rows_valid: int):
        import torch

        from predictionio_tpu_torch.ops.topk import (_NEG, _topk_ordered, adc_shortlist,
                                                     merge_shortlists, rerank_partial)

        k, home = self.k, self.device
        with self._lock:
            self._ids_host.numpy()[:] = user_ids
            self._ids.copy_(self._ids_host, non_blocking=True)
            Q = scorer._U.index_select(0, self._ids)
            Q = torch.where(self._rows < rows_valid, Q, torch.zeros_like(Q))
            Qs = [Q.to(dev) for dev in scorer.slots]
            lists = []
            for s, dev in enumerate(scorer.slots):
                rot = scorer._rot_at[s]
                Qr = Qs[s] if rot is None else Qs[s] @ rot
                lists.append(adc_shortlist(
                    Qr, scorer._codebooks_at[s], scorer._codes[s], scorer.shortlist,
                    n_valid=scorer.n_items, col_offset=s * scorer.local_n))
            _mv, mi = merge_shortlists(
                torch.stack([v.to(home) for v, _ in lists]),
                torch.stack([i.to(home) for _, i in lists]), scorer.shortlist)
            exact = None
            for s, dev in enumerate(scorer.slots):
                part = rerank_partial(Qs[s], scorer._V_parts[s], mi.to(dev),
                                      s * scorer.local_n).to(home)
                exact = part if exact is None else exact + part
            # zero-padded V rows re-rank to 0.0, which would beat a real
            # candidate's negative score: push any pad candidate below all
            exact = torch.where(mi < scorer.n_items, exact,
                                torch.full_like(exact, _NEG))
            pos = _topk_ordered(exact, torch.arange(exact.shape[1], dtype=torch.int64,
                                                    device=home), k)
            self._packed[:, :k] = exact.gather(1, pos)
            self._packed[:, k:] = mi.gather(1, pos).to(torch.float32)
            self._packed_host.copy_(self._packed, non_blocking=True)
            if home.type == "cuda":
                for dev in set(scorer.slots):
                    torch.cuda.current_stream(dev).synchronize()
            packed = self._packed_host.numpy().copy()
        return packed[:, :k], packed[:, k:].astype(np.int32)


class ShardedANNScorer(ANNScorer):
    """ANN scorer with the serving corpus partitioned item-wise over a
    ``"shards"`` mesh axis: each slot holds ``1/S`` of the PQ codes and
    of the exact-rerank vectors, the queries replicate, and one program
    runs scan → gather → merge → re-rank over the slots.

    Slot i owns the global rows [i·local_n, (i+1)·local_n); pad rows
    live only in the last slot's tail and never win. Per-slot residency
    is ``local_n · (m + 4·dim)`` bytes plus the replicated codebooks and
    rotation; the user table stays on the first slot. Same external
    contract as :class:`ANNScorer`; ``shards=1`` is bitwise identical to
    it. ``mesh`` (a ``parallel/mesh.Mesh`` with a ``"shards"`` axis) is
    built by ``shards_mesh(shards)`` over this process's slots of
    ``device``'s type when not given; its slots must all be this
    process's.
    """

    _program = _ShardedANNProgram

    def __init__(self, U: np.ndarray, V: np.ndarray, index: PQIndex,
                 shortlist: int = DEFAULT_SHORTLIST, *,
                 shards: Optional[int] = None, mesh=None, device=None):
        from predictionio_tpu_torch.parallel.mesh import process_slots, shards_mesh
        from predictionio_tpu_torch.utils.device import resolve_device

        if mesh is None:
            if not shards or int(shards) < 1:
                raise ValueError(
                    "ShardedANNScorer needs shards >= 1 or an explicit mesh")
            mesh = shards_mesh(int(shards), platform=resolve_device(device).type)
        if "shards" not in mesh.axis_names:
            raise ValueError(
                'sharded ANN serving mesh must carry a "shards" axis')
        self.mesh = mesh
        self.slots = process_slots(mesh, "sharded ANN serving", "shards")
        self.shards = len(self.slots)
        super().__init__(U, V, index, shortlist=shortlist, device=self.slots[0])

    def _place(self, U, V, index: PQIndex) -> None:
        import torch

        from predictionio_tpu_torch.parallel.mesh import pad_to_multiple
        from predictionio_tpu_torch.server import aot

        #: padded item rows a slot
        self.local_n = pad_to_multiple(self.n_items, self.shards) // self.shards
        # a slot can only nominate from its own rows, so k′ beyond local_n
        # is meaningless (and would break the local top-k)
        self.shortlist = max(1, min(self.shortlist, self.local_n))
        n_pad = self.local_n * self.shards
        Vp = np.asarray(V, np.float32)
        codesT = np.asarray(index.codes, np.uint8).T
        if n_pad != self.n_items:
            Vp = np.concatenate([Vp, np.zeros(
                (n_pad - self.n_items, self.rank), np.float32)])
            codesT = np.concatenate([codesT, np.zeros(
                (self.m, n_pad - self.n_items), np.uint8)], axis=1)

        def put(a, dtype, dev):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self._U = put(U, np.float32, self.device)
        cuts = [slice(s * self.local_n, (s + 1) * self.local_n)
                for s in range(self.shards)]
        self._V_parts = [put(Vp[c], np.float32, dev) for c, dev in zip(cuts, self.slots)]
        self._codes = [put(codesT[:, c], np.uint8, dev) for c, dev in zip(cuts, self.slots)]
        self._codebooks_at = [put(index.codebooks, np.float32, dev) for dev in self.slots]
        self._rot_at = [None if index.rotation is None
                        else put(index.rotation, np.float32, dev) for dev in self.slots]
        aot.record_shard_layout(self.shards, self.local_n, self.shortlist)

    def _aot_key(self, B: int, k: int) -> tuple:
        return ("ann_sharded_topk", self.n_users, self.rank, self.m, self.K,
                self.n_items, self.local_n, self.shards, B, k, self.shortlist,
                self._rot_at[0] is not None, tuple(str(d) for d in self.slots))


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
    build hint) selects the mesh-sharded scorer over this process's
    slots of ``device``'s type; with fewer slots than shards it logs
    the JAX package's warning and serves unsharded.
    """
    import logging

    from predictionio_tpu_torch.parallel.mesh import device_count
    from predictionio_tpu_torch.utils.device import resolve_device

    if index is None:
        return None
    if not serve_on_device(V.shape[0]):
        return None
    want = _resolve_shards(index, shards)
    if want > 1:
        have = device_count(resolve_device(device).type)
        if have >= want:
            if (cached is not None and type(cached) is ShardedANNScorer
                    and cached.built_from(U, V, device)
                    and cached._want_shortlist == int(shortlist)
                    and cached.shards == want):
                return cached
            return ShardedANNScorer(U, V, index, shortlist=shortlist,
                                    shards=want, device=device)
        logging.getLogger("pio.ann").warning(
            "sharded ANN serving unavailable (%s); serving unsharded",
            f"mesh needs {want} devices, have {have}")
    if (cached is not None and type(cached) is ANNScorer
            and cached.built_from(U, V, device)
            and cached._want_shortlist == int(shortlist)):
        return cached
    return ANNScorer(U, V, index, shortlist=shortlist, device=device)


def load_blob_index(d: dict, instance_dir: Optional[str]):
    """A template blob dict's PQ index: ``ann_index.bin`` in
    ``instance_dir`` when there is one (sidecar and payload digests
    verified), else the blob's own bytes (payload digest verified), else
    None. Any mismatch raises
    ``IntegrityError``, which ``/reload`` turns into a refused candidate."""
    from predictionio_tpu_torch.ann.index import load_index

    index = load_index(instance_dir) if instance_dir else None
    if index is None and d.get("ann_index") is not None:
        index = PQIndex.from_bytes(d["ann_index"])
    return index
