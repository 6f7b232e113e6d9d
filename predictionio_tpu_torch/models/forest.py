"""Random forest classification on the card: oblivious (level-wise) trees.

The port of the JAX package's ``models/forest.py`` (the reference
template's MLlib ``RandomForest`` variant). Every node at a depth shares
one (feature, threshold) split, so a depth-D tree is D (feature,
threshold) pairs and a (2^D, C) leaf table. Candidate thresholds are
per-feature quantiles on the host (:func:`_thresholds`). One level scores
every candidate split at once: the per-(leaf, class) histogram of each
candidate is one f32 matmul of the (n, d·n_thr) ``above`` table against
the (n, L·C) bootstrap-weighted leaf table, and the Gini of both sides
is a few elementwise ops; the split is the first index of the lowest
score. The histograms are sums of small integers, so they are exact in
f32 in any summation order.

``above`` depends only on X and the thresholds, so it is built once for
every tree; the trees run one after another (the JAX package vmaps
them). The draws — bootstrap counts (``n`` draws with replacement,
counted) and per-level feature masks (``uniform < feature_frac``) — come
from a ``torch.Generator`` seeded with ``seed``; the JAX package draws
from ``jax.random``, which the port does not reproduce, so a seeded run
grows other trees in each package. :func:`forest_train_drawn` takes the
draws as arguments, which is how the tests carry ``jax.random``'s draws
across. Prediction is host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.utils.device import full_f32, resolve_device


@dataclass
class ForestParams:
    n_trees: int = 16
    max_depth: int = 5
    n_thresholds: int = 16     # candidate quantile thresholds per feature
    feature_frac: float = 0.7  # features sampled per level (per tree)
    seed: int = 0


@dataclass
class ForestModel:
    feats: np.ndarray       # (T, D) int32 — split feature per depth
    thrs: np.ndarray        # (T, D) f32  — split threshold per depth
    leaf_probs: np.ndarray  # (T, 2^D, C) f32
    n_classes: int


def _thresholds(X: np.ndarray, n_thr: int) -> np.ndarray:
    """(d, n_thr) per-feature candidate thresholds at inner quantiles."""
    qs = np.linspace(0, 1, n_thr + 2)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)  # (d, n_thr)


def forest_draws(n: int, d: int, p: ForestParams):
    """The port's draws for ``p``: bootstrap counts (T, n) f32 and
    per-level feature masks (T, D, d) bool, from a ``torch.Generator``
    seeded with ``p.seed`` (on the CPU, so a seed gives the same draws on
    every device)."""
    g = torch.Generator().manual_seed(int(p.seed))
    T, D = int(p.n_trees), int(p.max_depth)
    boot = torch.stack([
        torch.bincount(torch.randint(0, n, (n,), generator=g), minlength=n)
        for _ in range(T)]).float()
    keep = torch.rand((T, D, d), generator=g) < float(p.feature_frac)
    return boot, keep


def _gini(h: torch.Tensor) -> torch.Tensor:
    """Σ_leaves s·(1 − Σ_k p_k²) of (c, L, C) histograms → (c,)."""
    s = h.sum(-1)
    p = h / torch.clamp(s, min=1e-9)[..., None]
    return (s * (1.0 - (p * p).sum(-1))).sum(-1)


def _grow_tree(Xd, Yoh, above, thr_flat, fidx, boot, keep, D: int):
    """One tree on the device: (feats (D,), thrs (D,), leaf_probs (L, C))."""
    n, C = Yoh.shape
    L = 1 << D
    Yw = Yoh * boot[:, None]                          # bootstrap-weighted labels
    leaf = torch.zeros(n, dtype=torch.int64, device=Xd.device)
    rows = torch.arange(n, device=Xd.device)
    feats, thrs = [], []
    for depth in range(D):
        # (n, L·C): row i holds Yw[i] in the column block of its leaf
        ly = torch.zeros((n, L * C), dtype=torch.float32, device=Xd.device)
        ly.view(n, L, C)[rows, leaf] = Yw
        with full_f32():
            hi = (above.T @ ly).view(-1, L, C)         # (n_cand, L, C)
        lo = ly.view(n, L, C).sum(0)[None] - hi
        score = _gini(hi) + _gini(lo)
        # candidates on dropped features score +inf
        score = torch.where(keep[depth][fidx], score,
                            torch.full_like(score, float("inf")))
        best = int(torch.argmin(score))              # first index of the least
        f_b = int(fidx[best])
        t_b = thr_flat[best]
        leaf = leaf * 2 + (Xd[:, f_b] > t_b).long()
        if depth + 1 >= D:
            # leaf ids are final at depth D; the JAX scan clamps them
            leaf = torch.clamp(leaf, max=L - 1)
        feats.append(f_b)
        thrs.append(t_b)
    counts = torch.zeros((L, C), dtype=torch.float32, device=Xd.device)
    counts.index_add_(0, leaf, Yw)
    counts = counts + 1e-3
    probs = counts / counts.sum(-1, keepdim=True)
    return feats, torch.stack(thrs), probs


def forest_train_drawn(X: np.ndarray, y: np.ndarray, p: ForestParams,
                       boot, keep, device=None) -> ForestModel:
    """Train the ensemble from given draws: ``boot`` (T, n) bootstrap
    counts and ``keep`` (T, D, d) per-level feature masks."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int64)
    C = int(y.max()) + 1 if y.size else 1
    n, d = X.shape
    T, D, n_thr = int(p.n_trees), int(p.max_depth), int(p.n_thresholds)
    thr = _thresholds(X, n_thr)
    Xd = torch.as_tensor(X).to(dev)
    Yoh = torch.nn.functional.one_hot(torch.as_tensor(y).to(dev), C).float()
    thr_flat = torch.as_tensor(thr.reshape(-1)).to(dev)
    # candidate c = (feature c // n_thr, threshold c % n_thr)
    fidx = torch.arange(d * n_thr, device=dev) // n_thr
    above = (Xd[:, fidx] > thr_flat[None, :]).float()  # (n, d·n_thr), every tree
    boot = torch.as_tensor(np.asarray(boot, np.float32)).to(dev)
    keep = torch.as_tensor(np.asarray(keep, bool)).to(dev)
    feats = np.zeros((T, D), np.int32)
    thrs, probs = [], []
    for t in range(T):
        f, th, pr = _grow_tree(Xd, Yoh, above, thr_flat, fidx, boot[t],
                               keep[t], D)
        feats[t] = f
        thrs.append(th)
        probs.append(pr)
    return ForestModel(feats, torch.stack(thrs).cpu().numpy(),
                       torch.stack(probs).cpu().numpy(), C)


def forest_train(X: np.ndarray, y: np.ndarray, p: ForestParams,
                 device=None) -> ForestModel:
    """Train the ensemble on ``device`` (CUDA unless the caller passes
    "cpu") with the port's seeded draws."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    boot, keep = forest_draws(X.shape[0], X.shape[1], p)
    return forest_train_drawn(X, y, p, boot, keep, device=dev)


def forest_predict_proba(model: ForestModel, X: np.ndarray) -> np.ndarray:
    """(m, C) class probabilities, averaged over trees (host numpy)."""
    X = np.asarray(X, np.float32)
    T, D = model.feats.shape
    leaf = np.zeros((T, X.shape[0]), np.int64)
    for dep in range(D):
        f = model.feats[:, dep]                      # (T,)
        t = model.thrs[:, dep]
        leaf = leaf * 2 + (X[:, f].T > t[:, None]).astype(np.int64)
    probs = model.leaf_probs[np.arange(T)[:, None], leaf]  # (T, m, C)
    return probs.mean(axis=0)


def forest_predict(model: ForestModel, X: np.ndarray) -> np.ndarray:
    return np.argmax(forest_predict_proba(model, X), axis=-1)
