"""Plain reference of two-tower retrieval served through a PQ index, in
float64, in plain PyTorch. It imports nothing of the program.

- ``tower64``: the user tower (embedding → Dense + ReLU … → Dense →
  x / (1e-8 + |x|)) from the benchmark's own weights.
- ``lloyd64``: the PQ codebooks worked out again, Lloyd's k-means per
  subspace in float64 from the configuration's seeded sample and
  starting centroids, drawn as the configuration's build draws them.
- ``Replay``: one query replayed over the program's index, which the
  reference follows as the program's state: the float64 ADC score of
  every item, a bound on the float32 scan's error of each (rounding of
  the LUT's ``dsub``-term products and of the ``m``-term sum, Higham's
  γ_n = n·u / (1 − n·u), u = 2⁻²⁴; the port's smoke script's
  ``adc_f32_bound``), and from them the items that may be in the
  float32 shortlist and those that are in it whatever the rounding.
- ``judge``: one served answer against its replay.
- ``nearest_codes_miss``: the index's codes against the nearest
  centroid in float64, up to float32 near-ties.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
U32 = 2.0 ** -24


def gamma(n: int) -> float:
    return n * U32 / (1 - n * U32)


def tower64(params: dict, ids, device) -> torch.Tensor:
    """(len(ids), out_dim) user embeddings in float64."""
    p = params["params"]
    ids = torch.as_tensor(ids, device=device).long()
    x = torch.as_tensor(p["Embed_0"]["embedding"], device=device)[ids].to(F64)
    names = sorted((k for k in p if k.startswith("Dense_")), key=lambda k: int(k.split("_")[1]))
    for j, n in enumerate(names):
        x = x @ torch.as_tensor(p[n]["kernel"], device=device).to(F64) \
            + torch.as_tensor(p[n]["bias"], device=device).to(F64)
        if j < len(names) - 1:
            x = torch.relu(x)
    return x / (1e-8 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))


def lloyd64(V, m: int, K: int, iters: int, seed: int, sample: int, device,
            chunk: int = 8192) -> torch.Tensor:
    """(m, K, dim/m) float64 PQ codebooks of the float32 items ``V``:
    at most ``sample`` rows drawn without replacement by
    ``np.random.default_rng(seed)``, then the K starting centroids drawn
    from those rows by the same generator, then ``iters`` Lloyd steps
    per subspace (assign every row to its nearest centroid, move each
    centroid to the mean of its rows; a centroid with no row stays)."""
    V = np.asarray(V, np.float32)
    n, dim = V.shape
    dsub = dim // m
    rng = np.random.default_rng(seed)
    X = V[rng.choice(n, size=sample, replace=False)] if n > sample else V
    if len(X) < K:
        raise ValueError(f"{len(X)} sample rows for {K} centroids")
    Xs = torch.as_tensor(X, device=device).to(F64).reshape(len(X), m, dsub).transpose(0, 1)
    C = Xs[:, torch.as_tensor(rng.choice(len(X), size=K, replace=False), device=device)]
    for _ in range(iters):
        sums = torch.zeros_like(C)
        cnt = torch.zeros((m, K), dtype=F64, device=C.device)
        for lo in range(0, Xs.shape[1], chunk):
            x = Xs[:, lo:lo + chunk]
            a = ((x[:, :, None, :] - C[:, None, :, :]).pow(2).sum(-1)).argmin(-1)
            sums.scatter_add_(1, a[..., None].expand(-1, -1, dsub), x)
            cnt.scatter_add_(1, a, torch.ones_like(a, dtype=F64))
        C = torch.where(cnt[..., None] > 0, sums / cnt.clamp(min=1)[..., None], C)
    return C


class Index:
    """The program's PQ index on ``device``: codebooks (m, K, dsub) and
    codes transposed to (m, N)."""

    def __init__(self, codebooks, codes, device) -> None:
        self.cb = torch.as_tensor(codebooks, device=device).to(F64)
        self.codesT = torch.as_tensor(codes, device=device).T.long().contiguous()
        self.m, self.K, self.dsub = self.cb.shape
        self.n = self.codesT.shape[1]


class Replay:
    """One query ``q`` (float64 copy of the program's float32 query) over
    the index: float64 ADC scores, their float32 error bounds, and which
    items may be, and which surely are, in the top ``kprime``."""

    def __init__(self, q: torch.Tensor, index: Index, kprime: int) -> None:
        m, dsub = index.m, index.dsub
        qs = q.reshape(m, dsub)
        lut = torch.einsum("md,mkd->mk", qs, index.cb)
        lut_abs = torch.einsum("md,mkd->mk", qs.abs(), index.cb.abs())
        adc = torch.zeros(index.n, dtype=F64, device=q.device)
        bound = torch.zeros_like(adc)
        for mi in range(m):
            c = index.codesT[mi]
            adc += lut[mi][c]
            bound += gamma(m - 1) * lut[mi][c].abs() + gamma(dsub) * lut_abs[mi][c]
        self.adc, self.bound, self.kprime = adc, bound, kprime
        self.sorted_lo = torch.sort(adc - bound).values
        top = torch.topk(adc, min(kprime, index.n)).indices
        hi_sorted = torch.sort(adc + bound).values
        # items whose float64 score less its bound is reached by fewer than
        # kprime other items' score plus bound: in the shortlist for sure
        reach = index.n - torch.searchsorted(hi_sorted, (adc - bound)[top], right=True)
        self.sure = top[(reach - 1) < kprime].tolist()

    def possible(self, j: int) -> bool:
        """Fewer than kprime items are above item j for certain."""
        hi = self.adc[j] + self.bound[j]
        above = len(self.sorted_lo) - int(torch.searchsorted(self.sorted_lo, hi, right=True))
        return above < self.kprime


def judge(answer_items, answer_scores, q64: torch.Tensor, V64, replay: Replay, num: int):
    """The faults of one served answer that no float32 rounding explains,
    and (score error, rank gap) for the record.

    A fault: a length other than ``num``; a repeated item; an item that
    cannot be in the float32 shortlist; a served score farther from the
    item's float64 score than the float32 rounding of a d-term dot
    product can put it, γ_d·Σ_t |q_t v_t| (Higham) plus the rounding of
    the result; a rank at which the served item's float64 score lies
    below the reference's item at that rank (the top ``num`` by float64
    score of the sure shortlist and the served items) by more than two
    such roundings. The score error is the largest distance of a served
    score from its float64 score, the rank gap the largest such shortfall."""
    d = q64.shape[0]
    faults = 0
    if len(answer_items) != num or len(set(answer_items)) != len(answer_items):
        faults += 1
    exact, tol = {}, {}
    for j in set(answer_items) | set(replay.sure):
        v = V64[j]
        exact[j] = float(v @ q64)
        tol[j] = gamma(d) * float((v * q64).abs().sum()) + U32 * abs(exact[j])
    ranked = sorted(exact, key=lambda j: (-exact[j], j))[:num]
    score_err = gap = 0.0
    for j, s in zip(answer_items, answer_scores):
        if not replay.possible(j):
            faults += 1
        err = abs(s - exact[j])
        score_err = max(score_err, err)
        if err > tol[j]:
            faults += 1
    for r, j in zip(ranked, answer_items):
        short = exact[r] - exact[j]
        gap = max(gap, short)
        if short > tol[r] + tol[j]:
            faults += 1
    return faults, score_err, gap


def nearest_codes_miss(V_rows: torch.Tensor, codes_rows: torch.Tensor, index: Index) -> int:
    """Rows whose code in some subspace is farther in float64 than the
    nearest centroid by more than two float32 roundings of the encoder's
    distance |c|² − 2 x·c can explain: 2·γ_{dsub+2}·(|x| + max |c|)²."""
    m, K, dsub = index.cb.shape
    rel = 2 * gamma(dsub + 2)
    x = V_rows.to(F64).reshape(-1, m, dsub).transpose(0, 1)            # (m, R, dsub)
    d = (index.cb.pow(2).sum(-1)[:, None, :]
         - 2.0 * torch.bmm(x, index.cb.transpose(1, 2)))                # (m, R, K)
    best = d.min(-1).values
    got = d.gather(2, codes_rows.long().T[..., None])[..., 0]           # (m, R)
    scale = (x.norm(dim=-1) + index.cb.norm(dim=-1).max(-1).values[:, None]).pow(2)
    miss = (got - best) > rel * scale
    return int(miss.any(0).sum())
