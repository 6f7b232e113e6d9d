"""Correlated Cross-Occurrence (CCO) with LLR filtering on the card.

The port of the JAX package's ``models/cco.py`` (the Universal
Recommender's Mahout-Samsara ``SimilarityAnalysis.cooccurrencesIDSs``:
LLR-thresholded co-occurrence of a primary event with each secondary
event type):

- the co-occurrence products ``PᵀP_e`` run as **dense user-chunk
  matmuls** on the training device: for each chunk of users a dense
  ``(chunk, n_items)`` 0/1 slab is scattered on the device from the CSR
  and accumulated into ``C`` in f32 at full precision (no TF32). Counts
  of 0/1 slabs are integers below 2²⁴, so they are exact in any
  summation order and equal the JAX package's bit for bit; ``C`` stays
  on the device for the LLR stage;
- the Dunning log-likelihood ratio is evaluated elementwise on ``C`` in
  row blocks in f32 (the JAX package's formula, term for term), then a
  per-row top-k over an int64 (value, complement of column) key, so
  ties give the lowest column first as ``lax.top_k`` does — including
  the ``-inf`` fill of rows with fewer than k live entries;
- above ``CCOParams.dense_c_max_mb`` the SPARSE path runs on the host
  (numpy only, copied verbatim: pair expansion + ``np.unique``, LLR in
  float64 rounded to f32, per-row top-k by lexsort).

Serving: :class:`CCOResidentScorer` keeps the indicator arrays resident
on the device; a query is one device program (history bitmap by
scatter-max, gather, boosted weighted sum, popularity fallback, top-k)
and one fetch. :func:`score_user` is the host reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.topk import _order_keys
from predictionio_tpu_torch.utils.device import full_f32, resolve_device


@dataclass
class CCOParams:
    max_indicators_per_item: int = 50   # Mahout maxInterestingItemsPerThing
    llr_threshold: float = 0.0
    user_chunk: int = 2048
    row_block: int = 4096
    # Mahout maxNumInteractions: cap a user's interactions per event
    # type (deterministic subsample). A user with p primary and s
    # secondary interactions contributes p·s co-occurrence pairs, so an
    # uncapped power-law head costs quadratic pairs AND adds little
    # signal (Mahout's rationale).
    max_interactions_per_user: int = 500
    # Crossover to the sparse path: if the dense (n_a, n_b) f32 count
    # matrix would exceed this, co-occurrence runs sparse (see module
    # docstring).
    dense_c_max_mb: int = 1024


class _Walls:
    """Wall seconds by stage for ``cco_indicators(timings=...)``: each
    lap synchronises the device first, so a stage's wall is its own.
    With ``out`` None every lap is free (no sync)."""

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device) -> None:
        self.out, self.device, self.t = out, device, time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[stage] = self.out.get(stage, 0.0) + now - self.t
        self.t = now


def _downsample_per_user(users: np.ndarray, items: np.ndarray,
                         cap: int, seed: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Cap each user's interactions at ``cap`` by deterministic
    subsample (vectorized; order not preserved)."""
    if cap <= 0 or users.size <= cap:
        return users, items
    counts = np.bincount(users)
    if counts.max(initial=0) <= cap:
        return users, items
    # random priority per event, keep a user's `cap` smallest
    rng = np.random.default_rng(seed)
    pri = rng.random(users.size)
    order = np.lexsort((pri, users))          # group by user, random within
    us = users[order]
    within = np.arange(users.size) - np.concatenate(
        ([0], np.cumsum(np.bincount(us))))[us]
    keep = order[within < cap]
    return users[keep], items[keep]


def _csr_from_pairs(users: np.ndarray, items: np.ndarray, n_users: int,
                    n_items: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dedup (user, item) pairs → CSR (indptr, indices) of the 0/1 matrix."""
    keys = users.astype(np.int64) * n_items + items.astype(np.int64)
    keys = np.unique(keys)  # sorted → u is already nondecreasing
    u = (keys // n_items).astype(np.int32)
    i = (keys % n_items).astype(np.int32)
    indptr = np.zeros(n_users + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n_users), out=indptr[1:])
    return indptr, i


def _cooccurrence(primary: Tuple[np.ndarray, np.ndarray],
                  secondary: Tuple[np.ndarray, np.ndarray],
                  n_users: int, n_a: int, n_b: int, chunk: int,
                  device=None, walls: Optional[_Walls] = None) -> torch.Tensor:
    """C = PᵀS over user chunks, on ``device``: each chunk's two dense
    0/1 slabs are scattered there from the CSR and multiplied in f32 at
    full precision. Returns the (n_a, n_b) f32 counts ON the device."""
    dev = resolve_device(device)
    walls = walls or _Walls(None, dev)
    slabs = []
    for (indptr, idx), width in ((primary, n_a), (secondary, n_b)):
        slabs.append((indptr, torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(dev),
                      torch.from_numpy(np.diff(indptr)).to(dev),
                      torch.zeros((chunk, width), dtype=torch.float32, device=dev)))
    rows = torch.arange(chunk, device=dev)
    C = torch.zeros((n_a, n_b), dtype=torch.float32, device=dev)
    with full_f32():
        for start in range(0, n_users, chunk):
            stop = min(start + chunk, n_users)
            for indptr, idx, lens, slab in slabs:
                slab.zero_()
                lo, hi = int(indptr[start]), int(indptr[stop])
                if hi > lo:
                    r = torch.repeat_interleave(rows[:stop - start], lens[start:stop],
                                                output_size=hi - lo)
                    slab[r, idx[lo:hi]] = 1.0
            walls.lap("slabs")
            C.addmm_(slabs[0][3].T, slabs[1][3])
            walls.lap("products")
    return C


def _cooccurrence_sparse(primary: Tuple[np.ndarray, np.ndarray],
                         secondary: Tuple[np.ndarray, np.ndarray],
                         n_users: int, n_b: int,
                         budget: int = 8_000_000,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse C = PᵀS: only the live entries, by vectorized per-user
    pair expansion. Returns (rows, cols, counts) with rows ascending.

    Per user u the pairs are the cross product of u's primary items and
    u's secondary items — Σ p_u·s_u pairs total (downsampling bounds
    the per-user quadratic term). Expansion is pure index arithmetic:
    no Python loop over users, one ``np.unique`` per pair-budget chunk,
    one final merge."""
    p_indptr, s_indptr = primary[0], secondary[0]
    p_idx, s_idx = primary[1], secondary[1]
    # Chunk by PAIR budget, not user count: per-user cost here is
    # p_u·s_u (up to cap² = 250k at the default downsampling cap), so a
    # user-count chunk of cap-heavy users would expand tens of GB of
    # index arrays at once. ~8M pairs ≈ 300 MB transient.
    all_pairs = (np.diff(p_indptr) * np.diff(s_indptr)).astype(np.int64)
    cum = np.concatenate(([0], np.cumsum(all_pairs)))
    # FIXED budget: a user whose own pair count exceeds it (possible
    # with downsampling disabled, cap<=0) is expanded in budget-sized
    # sub-slices below rather than by inflating the budget to the max
    # per-user count — the latter made transient memory unbounded.
    bounds = [0]
    while bounds[-1] < n_users:
        nxt = int(np.searchsorted(cum, cum[bounds[-1]] + budget,
                                  side="right")) - 1
        bounds.append(max(nxt, bounds[-1] + 1))
    parts = []
    for start, stop in zip(bounds[:-1], bounds[1:]):
        p_cnt = np.diff(p_indptr[start:stop + 1])
        s_cnt = np.diff(s_indptr[start:stop + 1])
        pairs = (p_cnt * s_cnt).astype(np.int64)
        total = int(pairs.sum())
        if total == 0:
            continue
        starts = np.concatenate(([0], np.cumsum(pairs)))
        for lo in range(0, total, budget):
            hi = min(lo + budget, total)
            if lo == 0 and hi == total:
                # common case (one sub-slice per chunk): O(total)
                # repeat beats the searchsorted mapping below
                seg = np.repeat(np.arange(stop - start), pairs)
                within = np.arange(total, dtype=np.int64) - starts[seg]
            else:
                gidx = np.arange(lo, hi, dtype=np.int64)
                # side="right" maps each global pair index to its
                # owning user, skipping zero-pair users' empty ranges
                seg = np.searchsorted(starts, gidx, side="right") - 1
                within = gidx - starts[seg]
            p_lo = p_indptr[start:stop][seg] + within // s_cnt[seg]
            s_lo = s_indptr[start:stop][seg] + within % s_cnt[seg]
            lin = p_idx[p_lo].astype(np.int64) * n_b + s_idx[s_lo]
            uniq, cnt = np.unique(lin, return_counts=True)
            parts.append((uniq, cnt.astype(np.float32)))
    if not parts:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    lin = np.concatenate([u for u, _ in parts])
    cnt = np.concatenate([c for _, c in parts])
    uniq, inv = np.unique(lin, return_inverse=True)
    counts = np.bincount(inv, weights=cnt).astype(np.float32)
    return ((uniq // n_b).astype(np.int32), (uniq % n_b).astype(np.int32),
            counts)


def _llr_values(k11, rc, cc, n_users: int) -> np.ndarray:
    """Dunning LLR for sparse entries (same math as the dense block)."""
    k11 = k11.astype(np.float64)
    k12 = np.maximum(rc - k11, 0.0)
    k21 = np.maximum(cc - k11, 0.0)
    k22 = np.maximum(n_users - k11 - k12 - k21, 0.0)

    def xlogx(x):
        return np.where(x > 0, x * np.log(np.where(x > 0, x, 1.0)), 0.0)

    rowe = xlogx(k11 + k12) + xlogx(k21 + k22)
    cole = xlogx(k11 + k21) + xlogx(k12 + k22)
    mate = xlogx(k11) + xlogx(k12) + xlogx(k21) + xlogx(k22)
    return (2.0 * (mate - rowe - cole
                   + xlogx(np.float64(n_users)))).astype(np.float32)


def _llr_topk_sparse(rows: np.ndarray, cols: np.ndarray,
                     counts: np.ndarray, row_counts: np.ndarray,
                     col_counts: np.ndarray, n_users: int, n_a: int,
                     n_b: int, k: int, threshold: float,
                     same_space: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row top-k over the sparse LLR entries (lexsort, no dense C).
    Output matches :func:`_llr_topk`'s shape contract: (n_a, k) index
    and value arrays, missing entries at llr -inf / index 0."""
    k = min(k, n_b)
    if same_space and rows.size:
        keep = rows != cols
        rows, cols, counts = rows[keep], cols[keep], counts[keep]
    llr = _llr_values(counts, row_counts[rows], col_counts[cols], n_users)
    ok = llr >= threshold
    rows, cols, llr = rows[ok], cols[ok], llr[ok]
    out_i = np.zeros((n_a, k), np.int32)
    out_v = np.full((n_a, k), -np.inf, np.float32)
    if rows.size:
        order = np.lexsort((-llr, rows))
        rs, cs, vs = rows[order], cols[order], llr[order]
        starts = np.zeros(n_a + 1, np.int64)
        np.cumsum(np.bincount(rs, minlength=n_a), out=starts[1:])
        within = np.arange(rs.size) - starts[rs]
        keep = within < k
        out_i[rs[keep], within[keep]] = cs[keep]
        out_v[rs[keep], within[keep]] = vs[keep]
    return out_i, out_v


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x * torch.log(x), 0.0)


def _llr_block(Cb: torch.Tensor, rc: torch.Tensor, cc: torch.Tensor,
               n_users: int, threshold: float, diag_start: Optional[int]
               ) -> torch.Tensor:
    """The JAX package's f32 LLR of one row block, term for term:
    entries with no co-occurrence, below ``threshold`` or (same event
    space) on the diagonal are ``-inf``."""
    k11 = Cb
    k12 = torch.clamp_min(rc[:, None] - k11, 0.0)
    k21 = torch.clamp_min(cc[None, :] - k11, 0.0)
    k22 = torch.clamp_min(n_users - k11 - k12 - k21, 0.0)
    rowe = _xlogx(k11 + k12) + _xlogx(k21 + k22)
    cole = _xlogx(k11 + k21) + _xlogx(k12 + k22)
    mate = _xlogx(k11) + _xlogx(k12) + _xlogx(k21) + _xlogx(k22)
    n = torch.tensor(float(n_users), dtype=torch.float32, device=Cb.device)
    llr = 2.0 * (mate - rowe - cole + _xlogx(n))
    llr = torch.where(k11 > 0, llr, -torch.inf)
    llr = torch.where(llr >= threshold, llr, -torch.inf)
    if diag_start is not None:
        r = torch.arange(Cb.shape[0], device=Cb.device)[:, None] + diag_start
        c = torch.arange(Cb.shape[1], device=Cb.device)[None, :]
        llr = torch.where(r == c, -torch.inf, llr)
    return llr


def _llr_topk(C: torch.Tensor, row_counts: np.ndarray, col_counts: np.ndarray,
              n_users: int, k: int, threshold: float, row_block: int,
              same_space: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Dunning LLR per entry, then per-row top-k, on ``C``'s device.

    Returns (indices [n_a, k], llr [n_a, k]); entries below threshold get
    llr -inf. ``same_space`` masks the diagonal (self co-occurrence).
    """
    dev = C.device
    n_a, n_b = C.shape
    k = min(k, n_b)
    cc = torch.from_numpy(np.asarray(col_counts, np.float32)).to(dev)
    rcs = torch.from_numpy(np.asarray(row_counts, np.float32)).to(dev)
    cols = torch.arange(n_b, dtype=torch.int64, device=dev)
    out_i = torch.empty((n_a, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((n_a, k), dtype=torch.float32, device=dev)
    for start in range(0, n_a, row_block):
        stop = min(start + row_block, n_a)
        llr = _llr_block(C[start:stop], rcs[start:stop], cc, n_users, threshold,
                         start if same_space else None)
        pos = torch.topk(_order_keys(llr, cols), k, dim=1, sorted=True).indices
        out_v[start:stop] = llr.gather(1, pos)
        out_i[start:stop] = pos.to(torch.int32)
    return out_i.cpu().numpy(), out_v.cpu().numpy()


def cco_indicators(
    primary_pairs: Tuple[np.ndarray, np.ndarray],
    event_pairs: Dict[str, Tuple[np.ndarray, np.ndarray]],
    n_users: int,
    n_items_primary: int,
    n_items_by_event: Dict[str, int],
    params: Optional[CCOParams] = None,
    device=None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Compute LLR-filtered indicators for every event type, the dense
    path on ``device`` (CUDA unless the caller passes "cpu").

    ``primary_pairs`` = (user_idx, item_idx) of the primary (conversion)
    event; ``event_pairs[e]`` likewise for each event type (the primary
    should be included under its own name to get classic co-occurrence).
    Returns ``{event: (indices [n_items_primary, k], llr scores)}``.
    A ``timings`` dict receives the wall seconds of each stage
    (``downsample_csr`` on the host; ``slabs``, ``products`` and
    ``llr_topk`` on the dense path, ``sparse`` on the sparse one), the
    device synchronised at each stage's end.
    """
    p = params or CCOParams()
    return _cco_run(primary_pairs, event_pairs, n_users, n_items_primary,
                    n_items_by_event, p, [p], device, timings)[0]


def _cco_run(primary_pairs, event_pairs, n_users: int,
             n_items_primary: int, n_items_by_event: Dict[str, int],
             shared_p: CCOParams, consumers: Sequence[CCOParams], device=None,
             timings: Optional[Dict[str, float]] = None,
             ) -> List[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """Shared-count pipeline: the EXPENSIVE stage (downsampling, CSR,
    per-event co-occurrence counts) runs once, driven by ``shared_p``'s
    count-stage knobs; each consumer in ``consumers`` then pays only
    its own LLR/top-k (``llr_threshold``/``max_indicators_per_item``
    never touch the counts). One event's count matrix is alive at a
    time — every consumer reduces it to top-k before the next event's
    counts are built, so peak memory is one dense C, not n_events of
    them."""
    dev = resolve_device(device)
    walls = _Walls(timings, dev)
    cap = shared_p.max_interactions_per_user
    raw_primary = primary_pairs  # identity check below predates capping
    primary_pairs = _downsample_per_user(*primary_pairs, cap)
    prim = _csr_from_pairs(*primary_pairs, n_users, n_items_primary)
    prim_item_counts = np.bincount(
        prim[1], minlength=n_items_primary).astype(np.float32)
    walls.lap("downsample_csr")

    outs: List[Dict[str, Tuple[np.ndarray, np.ndarray]]] = \
        [{} for _ in consumers]
    for name, (eu, ei) in event_pairs.items():
        n_b = n_items_by_event[name]
        same = (name == "__primary__") or (n_b == n_items_primary and
                                           np.array_equal(ei, raw_primary[1]) and
                                           np.array_equal(eu, raw_primary[0]))
        eu, ei = _downsample_per_user(eu, ei, cap)
        sec = _csr_from_pairs(eu, ei, n_users, n_b)
        sec_item_counts = np.bincount(sec[1], minlength=n_b).astype(np.float32)
        walls.lap("downsample_csr")
        if n_items_primary * n_b * 4 > shared_p.dense_c_max_mb << 20:
            # catalog too large for a dense (n_a, n_b) C — sparse path
            rows, cols, cnts = _cooccurrence_sparse(prim, sec, n_users,
                                                    n_b)
            for p, out in zip(consumers, outs):
                out[name] = _llr_topk_sparse(
                    rows, cols, cnts, prim_item_counts, sec_item_counts,
                    n_users, n_items_primary, n_b,
                    p.max_indicators_per_item, p.llr_threshold, same)
            walls.lap("sparse")
        else:
            C = _cooccurrence(prim, sec, n_users, n_items_primary, n_b,
                              shared_p.user_chunk, dev, walls)
            for p, out in zip(consumers, outs):
                out[name] = _llr_topk(
                    C, prim_item_counts, sec_item_counts, n_users,
                    p.max_indicators_per_item, p.llr_threshold,
                    p.row_block, same)
            walls.lap("llr_topk")
            del C  # freed before the next event's counts are built
    return outs


def cco_indicators_many(
    primary_pairs: Tuple[np.ndarray, np.ndarray],
    event_pairs: Dict[str, Tuple[np.ndarray, np.ndarray]],
    n_users: int,
    n_items_primary: int,
    n_items_by_event: Dict[str, int],
    params_list: Sequence[CCOParams],
    device=None,
) -> List[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """Indicator sets for SEVERAL candidates on the same data — the
    `pio eval` grid fan-out. Candidates sharing the count-stage params
    (downsampling cap, user chunking, dense/sparse crossover) compute
    the co-occurrence counts ONCE; each pays only its own LLR/top-k.
    Results in input order."""
    out: List[Optional[Dict]] = [None] * len(params_list)
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(params_list):
        # ONLY the knobs that change the counts; row_block merely
        # blocks the per-candidate top-k and must not split a group
        key = (p.user_chunk, p.max_interactions_per_user,
               p.dense_c_max_mb)
        groups.setdefault(key, []).append(i)
    for idxs in groups.values():
        results = _cco_run(primary_pairs, event_pairs, n_users,
                           n_items_primary, n_items_by_event,
                           params_list[idxs[0]],
                           [params_list[i] for i in idxs], device)
        for i, res in zip(idxs, results):
            out[i] = res
    return out  # type: ignore[return-value]


def score_user(
    indicators: Dict[str, Tuple[np.ndarray, np.ndarray]],
    history: Dict[str, Sequence[int]],
    n_items: int,
    boosts: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Score all items for one user from their per-event history.

    score(j) = Σ_e boost_e · Σ_{h ∈ history_e} [h ∈ indicators_e(j)] · llr
    — the host-side reference implementation of the scoring math (kept
    for parity tests); serving uses :class:`CCOResidentScorer`, the
    one-program device path.
    """
    scores = np.zeros(n_items, np.float32)
    for name, hist in history.items():
        if name not in indicators or len(hist) == 0:
            continue
        idxs, vals = indicators[name]
        boost = (boosts or {}).get(name, 1.0)
        hset = set(int(h) for h in hist)
        # rows = items; find rows whose indicator lists intersect history
        mask = np.isin(idxs, list(hset)) & np.isfinite(vals)
        contrib = (np.where(mask, vals, 0.0)).sum(axis=1)
        scores += boost * contrib
    return scores


class CCOResidentScorer:
    """Universal-Recommender serving with indicators resident on the
    device.

    The per-event indicator arrays (item → top-k correlated items + LLR
    weights, ``-inf`` stored as 0) live on the device across requests.
    A query uploads one packed array (padded histories, their mask and
    the boosts) and runs one program: the history bitmap by scatter-max,
    the gather along the indicator lists and the boosted weighted sum,
    the popularity fallback when no score is > 0, and the top-k in
    ``lax.top_k``'s order; values and indices come back in one fetch.
    """

    _MIN_H = 16  # history padding bucket floor

    def __init__(self, indicators: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 n_items: int, popularity: np.ndarray, device=None) -> None:
        if n_items >= 1 << 24:
            # the packed single-fetch output carries item indices in
            # f32 (exact integers only below 2^24)
            raise ValueError(
                "CCOResidentScorer supports catalogs < 2^24 items")
        self.device = resolve_device(device)
        self.events = sorted(indicators)
        self.n_items = n_items
        dev = self.device
        self._idxs = tuple(
            torch.from_numpy(np.ascontiguousarray(indicators[e][0], np.int32)).to(dev)
            for e in self.events)
        self._vals = tuple(
            torch.from_numpy(np.where(np.isfinite(indicators[e][1]),
                                      indicators[e][1], 0.0).astype(np.float32)).to(dev)
            for e in self.events)
        self._pop = torch.from_numpy(np.asarray(popularity, np.float32)).to(dev)
        self._cols = torch.arange(n_items, dtype=torch.int64, device=dev)

    def _run(self, packed: np.ndarray, H: int, k: int) -> np.ndarray:
        """One query's device program over the uploaded (E, 2H + 1)
        array [histories | mask | boost]; returns [values | indices]."""
        q = torch.from_numpy(packed).to(self.device)
        hists, mask, boosts = q[:, :H].long(), q[:, H:2 * H], q[:, 2 * H]
        n = self.n_items
        scores = torch.zeros(n, dtype=torch.float32, device=self.device)
        for e, (ix, vv) in enumerate(zip(self._idxs, self._vals)):
            # membership bitmap over the catalog, then one gather along
            # the indicator lists — no per-row set scans
            bitmap = torch.zeros(n, dtype=torch.float32, device=self.device)
            bitmap.scatter_reduce_(0, hists[e], mask[e], "amax")
            hit = bitmap.index_select(0, ix.view(-1)).view(ix.shape)
            scores = scores + boosts[e] * (hit * vv).sum(1)
        # cold start / no indicator hits → popularity ranking
        scores = torch.where((scores > 0).any(), scores, self._pop)
        pos = torch.topk(_order_keys(scores[None], self._cols), k,
                         sorted=True).indices[0]
        return torch.cat([scores[pos], pos.to(torch.float32)]).cpu().numpy()

    def recommend(
        self,
        history: Dict[str, Sequence[int]],
        num: int,
        boosts: Optional[Dict[str, float]] = None,
        banned: Optional[Sequence[int]] = None,
    ) -> List[Tuple[int, float]]:
        """Top-``num`` (item_idx, score) pairs, scores > 0 only."""
        banned_set = set(int(b) for b in (banned or ()))
        max_h = max((len(history.get(e, ())) for e in self.events),
                    default=0)
        H = self._MIN_H
        while H < max_h:
            H *= 2
        E = len(self.events)
        packed = np.zeros((E, 2 * H + 1), np.float32)
        packed[:, 2 * H] = 1.0
        for e, name in enumerate(self.events):
            h = list(history.get(name, ()))[:H]
            packed[e, :len(h)] = h
            packed[e, H:H + len(h)] = 1.0
            if boosts and name in boosts:
                packed[e, 2 * H] = boosts[name]
        want = min(num + len(banned_set), self.n_items)
        k = 16
        while k < want:
            k *= 2
        k = min(k, self.n_items)
        out = self._run(packed, H, k)
        vals_k, idx_k = out[:k], out[k:].astype(np.int32)
        hits = []
        for i, v in zip(idx_k, vals_k):
            if v > 0 and int(i) not in banned_set and len(hits) < num:
                hits.append((int(i), float(v)))
        return hits
