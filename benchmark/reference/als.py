"""Plain reference of explicit ALS with MLlib's weighted λ (ALS-WR), in
float64, in plain PyTorch. It imports nothing of the program and works
its own layout out from the raw ratings.

For one side, each entity e with ratings solves

    (Σ_r f_r f_rᵀ + λ·n_e·I) x_e = Σ_r r · f_r

over its n_e ratings (duplicates counted), f_r the other side's factor
row of rating r; an entity with no rating gets the zero row. One train
starts from the given item factors V0 with U = 0 and runs ``iterations``
pairs of half-steps, users then items.

The layout: ratings sorted by entity, entities grouped by the power of
two their count rounds up to, each group gathered as a zero-padded
(entities, width, k) block and reduced with one batched product; an
entity with more than ``big`` ratings is reduced alone, ``big`` ratings
at a time.
"""

from __future__ import annotations

from typing import Tuple

import torch

F64 = torch.float64


class Side:
    """One orientation of the ratings, sorted by entity, on ``device``."""

    def __init__(self, self_idx, other_idx, rating, n_self: int, device,
                 big: int = 1 << 16) -> None:
        s = torch.as_tensor(self_idx, device=device).long()
        o = torch.as_tensor(other_idx, device=device).long()
        r = torch.as_tensor(rating, device=device).to(F64)
        order = torch.argsort(s, stable=True)
        self.s, self.o, self.r = s[order], o[order], r[order]
        self.n = n_self
        self.counts = torch.bincount(self.s, minlength=n_self)
        self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.big = big
        cnt = self.counts.cpu()
        self.groups = []  # (entities tensor, width)
        width = 1
        lo = 0
        while lo < int(cnt.max()) and width <= big:
            sel = torch.nonzero((cnt > lo) & (cnt <= width)).flatten()
            if len(sel):
                self.groups.append((sel.to(device), width))
            lo, width = width, width * 2
        self.heavy = torch.nonzero(cnt > big).flatten().tolist()

    def half(self, F: torch.Tensor, lam: float, slots: int = 1 << 22) -> torch.Tensor:
        """The float64 solution of every entity's normal equations given
        the other side's factors ``F`` (float64)."""
        k = F.shape[1]
        dev = F.device
        A = torch.zeros((self.n, k, k), dtype=F64, device=dev)
        b = torch.zeros((self.n, k), dtype=F64, device=dev)
        for ents, width in self.groups:
            step = max(1, slots // width)
            ar = torch.arange(width, device=dev)
            for lo in range(0, len(ents), step):
                e = ents[lo:lo + step]
                pos = self.starts[e][:, None] + ar[None, :]
                valid = ar[None, :] < self.counts[e][:, None]
                pos = torch.where(valid, pos, torch.zeros_like(pos))
                G = F[self.o[pos]] * valid[..., None]
                rr = self.r[pos] * valid
                A[e] = torch.bmm(G.transpose(1, 2), G)
                b[e] = torch.bmm(G.transpose(1, 2), rr[..., None])[..., 0]
        for e in self.heavy:
            lo, n = int(self.starts[e]), int(self.counts[e])
            for a in range(lo, lo + n, slots // k):
                z = min(a + slots // k, lo + n)
                G = F[self.o[a:z]]
                A[e] += G.T @ G
                b[e] += G.T @ self.r[a:z]
        rated = self.counts > 0
        lam_e = torch.clamp(lam * self.counts.to(F64), min=1e-8)
        A.diagonal(dim1=1, dim2=2).add_(lam_e[:, None])
        X = torch.zeros((self.n, k), dtype=F64, device=dev)
        idx = torch.nonzero(rated).flatten()
        for lo in range(0, len(idx), 1 << 15):
            e = idx[lo:lo + (1 << 15)]
            L = torch.linalg.cholesky(A[e])
            X[e] = torch.cholesky_solve(b[e][..., None], L)[..., 0]
        return X


class Ratings:
    """Both orientations of one ratings set."""

    def __init__(self, users, items, rating, n_users: int, n_items: int, device) -> None:
        self.users = Side(users, items, rating, n_users, device)
        self.items = Side(items, users, rating, n_items, device)
        self.device = device

    def train(self, V0, iterations: int, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
        V = torch.as_tensor(V0, device=self.device).to(F64)
        U = None
        for _ in range(iterations):
            U = self.users.half(V, lam)
            V = self.items.half(U, lam)
        return U, V

    def objective(self, U, V, lam: float, chunk: int = 1 << 22) -> float:
        """Σ (r − u·v)² + λ Σ_e n_e |x_e|² over both sides, in float64."""
        U = torch.as_tensor(U, device=self.device).to(F64)
        V = torch.as_tensor(V, device=self.device).to(F64)
        s = self.users
        sq = torch.zeros((), dtype=F64, device=self.device)
        for lo in range(0, len(s.s), chunk):
            u, i, r = s.s[lo:lo + chunk], s.o[lo:lo + chunk], s.r[lo:lo + chunk]
            sq += ((U[u] * V[i]).sum(1) - r).pow(2).sum()
        reg = ((self.users.counts.to(F64) * U.pow(2).sum(1)).sum()
               + (self.items.counts.to(F64) * V.pow(2).sum(1)).sum())
        return float(sq + lam * reg)


def normal_equations_err(side: Side, F_other, X_self, lam: float) -> float:
    """max |X − x64| / max |x64| over every entity of ``side``, x64 the
    float64 solve given ``F_other`` (the program's own other factors)."""
    dev = side.s.device
    x64 = side.half(torch.as_tensor(F_other, device=dev).to(F64), lam)
    got = torch.as_tensor(X_self, device=dev).to(F64)
    scale = float(x64.abs().max())
    diff = float((got - x64).abs().max())
    if not scale > 0.0:
        return float("inf")
    return diff / scale
