"""The one generator of inputs: ratings, initial factors, catalogs,
tower weights and query streams, all from ``--seed`` and the parameters
of a configuration or traffic file.

Every seed gets the same sizes: the ratings' pairs come from fixed
draws and the seed relabels users and items and draws the rating values,
so the layout, and so the work, is the same for every seed; a query
stream's users are drawn from the seed over a fixed law.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def count_law(n: int, lo: int, hi: int, total: int) -> np.ndarray:
    """``n`` whole counts, largest first, from ``hi`` down to ``lo``,
    summing to ``total``: c(r) = lo + A·(r^-α − n^-α) at ranks r = 1…n,
    A = (hi − lo)/(1 − n^-α), with α found by bisection so that the sum
    is ``total``; the rounding's remainder adds 1 to ranks 2, 3, …"""
    if not n * lo <= total <= n * hi:
        raise ValueError(f"no {n} counts in [{lo}, {hi}] sum to {total}")
    r = np.arange(1, n + 1, dtype=np.float64)

    def law(alpha):
        tail = n ** -alpha
        return lo + (hi - lo) * (r ** -alpha - tail) / (1.0 - tail)

    a, b = 1e-9, 64.0   # the sum falls as α grows
    for _ in range(200):
        mid = 0.5 * (a + b)
        a, b = (mid, b) if law(mid).sum() > total else (a, mid)
    c = np.floor(law(0.5 * (a + b)) + 1e-9).astype(np.int64)
    rem = int(total - c.sum())   # each floor loses under 1: 0 <= rem < n
    c[1:1 + rem] += 1
    return c


def law_ratings(nnz: int, n_users: int, n_items: int, draws_seed: int, user_min: int,
                user_max: int, item_min: int, item_max: int, device=None):
    """(users, items) of ``nnz`` distinct pairs: each user of rank r has
    ``count_law(n_users, user_min, user_max, nnz)[r]`` ratings, all of
    distinct items, drawn without replacement with weights the items'
    remaining room under ``count_law(n_items, item_min, item_max, nnz)``
    (Gumbel top-k on ``device``, users from the largest count down, a
    block of users at a time; an item past its room is drawn only when
    a user finds no other). Ids are ranks: user 0 and item 0 the most
    active."""
    import torch

    dev = torch.device(device or "cpu")
    cu = count_law(n_users, user_min, user_max, nnz)
    if cu[0] > n_items:
        raise ValueError(f"a user with {cu[0]} ratings of {n_items} items")
    room = torch.as_tensor(count_law(n_items, item_min, item_max, nnz),
                           dtype=torch.float64, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(draws_seed))
    rows_cap = max(1, (1 << 25) // n_items)
    slots = max(nnz // 256, 4096)
    csum = np.concatenate([[0], np.cumsum(cu)])
    users, items = [], []
    lo = 0
    while lo < n_users:
        fit = int(np.searchsorted(csum, csum[lo] + slots, side="right")) - 1
        hi = min(n_users, lo + rows_cap, max(lo + 1, fit))
        c = torch.as_tensor(cu[lo:hi], device=dev)
        u = torch.rand((hi - lo, n_items), generator=g, dtype=torch.float64, device=dev)
        keys = torch.log(room.clamp(min=0) + 1e-9) - torch.log(-torch.log(u))
        top = torch.topk(keys, int(cu[lo]), dim=1).indices
        take = torch.arange(int(cu[lo]), device=dev)[None, :] < c[:, None]
        picked = top[take]
        room -= torch.bincount(picked, minlength=n_items).to(room.dtype)
        users.append(np.repeat(np.arange(lo, hi, dtype=np.int32), cu[lo:hi]))
        items.append(picked.to(torch.int32).cpu().numpy())
        lo = hi
    return np.concatenate(users), np.concatenate(items)


def cached_law_ratings(cache_dir, *args, device=None):
    """:func:`law_ratings`, kept in ``cache_dir`` under a name made of its
    arguments: the draws are the same for every seed, so only a
    checkout's first run makes them."""
    import os

    path = os.path.join(str(cache_dir), "law-" + "-".join(str(a) for a in args) + ".npz")
    try:
        with np.load(path) as z:
            return z["users"], z["items"]
    except (OSError, KeyError, ValueError):
        users, items = law_ratings(*args, device=device)
        os.makedirs(str(cache_dir), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, users=users, items=items)
        os.replace(tmp, path)
        return users, items


def ratings(cfg: dict, seed: int, cache_dir=None,
            device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(users, items, ratings) of a ratings configuration for ``seed``:
    the fixed draws of :func:`law_ratings` (cached in ``cache_dir`` when
    given) relabelled by seeded permutations, ratings 0.5–5.0 in steps
    of 0.5 drawn from the seed."""
    d = cfg["ratings"]
    args = (cfg["num_ratings"], cfg["num_users"], cfg["num_items"], d["draws_seed"],
            d["user_min"], d["user_max"], d["item_min"], d["item_max"])
    users, items = (cached_law_ratings(cache_dir, *args, device=device)
                    if cache_dir is not None else law_ratings(*args, device=device))
    rng = np.random.default_rng([seed, 1])
    users = rng.permutation(cfg["num_users"]).astype(np.int32)[users]
    items = rng.permutation(cfg["num_items"]).astype(np.int32)[items]
    vals = (rng.integers(1, 11, size=len(users)) * 0.5).astype(np.float32)
    return users, items, vals


def initial_factors(torch, n: int, rank: int, seed: int, index: int, device) -> np.ndarray:
    """The initial item factors of train ``index``, N(0, 1/rank), drawn on
    ``device`` and handed over as the host array the program takes."""
    g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + index) % (1 << 63))
    V0 = torch.randn(n, rank, generator=g, device=device) / rank ** 0.5
    return V0.cpu().numpy()


def catalog(torch, n: int, d: int, seed: int, device):
    """``n`` unit-norm Gaussian item embeddings made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    V = torch.randn(n, d, generator=g, device=device)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    return V


def tower_weights(torch, n_users: int, embed_dim: int, hidden: list, out_dim: int,
                  seed: int, device) -> dict:
    """A user tower's weights in the template's (flax) format, made on the
    card: the embedding N(0, 0.05²), each kernel N(0, 1/fan_in), each
    bias N(0, 0.01²)."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    params = {"Embed_0": {"embedding": (0.05 * torch.randn(
        n_users, embed_dim, generator=g, device=device)).cpu().numpy()}}
    dims = [embed_dim, *hidden, out_dim]
    for j, (a, b) in enumerate(zip(dims, dims[1:])):
        params[f"Dense_{j}"] = {
            "kernel": (torch.randn(a, b, generator=g, device=device) / a ** 0.5).cpu().numpy(),
            "bias": (0.01 * torch.randn(b, generator=g, device=device)).cpu().numpy()}
    return {"params": params}


class UserLaw:
    """Users drawn uniformly or by a Zipf law of ranks over ``n`` users;
    the seed permutes which user holds which rank."""

    def __init__(self, spec: dict, n: int, seed: int) -> None:
        self.n = n
        self.rng = np.random.default_rng([seed, 3])
        self.kind = spec.get("dist", "uniform")
        if self.kind == "zipf":
            w = np.arange(1, n + 1, dtype=np.float64) ** -float(spec["exponent"])
            self.cdf = np.cumsum(w / w.sum())
            self.perm = self.rng.permutation(n)
        elif self.kind != "uniform":
            raise ValueError(f"unknown user law {self.kind!r}")

    def draw(self, count: int) -> np.ndarray:
        if self.kind == "uniform":
            return self.rng.integers(0, self.n, size=count)
        r = np.searchsorted(self.cdf, self.rng.random(count), side="right")
        return self.perm[np.minimum(r, self.n - 1)]


def query_lines(law: UserLaw, num: int, chunk: int) -> Iterator[str]:
    """An endless stream of ``{"user", "num"}`` JSON lines, drawn a chunk
    at a time."""
    while True:
        for u in law.draw(chunk):
            yield f'{{"user":"u{u}","num":{num}}}\n'
