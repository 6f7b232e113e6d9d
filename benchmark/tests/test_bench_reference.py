"""The plain references against direct solutions at tiny sizes."""

from __future__ import annotations

import numpy as np
import torch

from reference import als as ref_als
from reference import twotower as ref_tt


def _dense_half(self_idx, other_idx, r, n_self, F, lam):
    k = F.shape[1]
    X = np.zeros((n_self, k))
    for e in range(n_self):
        sel = self_idx == e
        if not sel.any():
            continue
        f = F[other_idx[sel]]
        A = f.T @ f + lam * sel.sum() * np.eye(k)
        X[e] = np.linalg.solve(A, f.T @ r[sel])
    return X


def test_als_half_step_matches_direct_solves():
    rng = np.random.default_rng(0)
    # one entity past the reference's heavy threshold, duplicates, an
    # entity with no rating
    u = np.concatenate([rng.integers(0, 30, 400), np.full(300, 7)]).astype(np.int32)
    i = rng.integers(0, 12, len(u)).astype(np.int32)
    r = rng.integers(1, 11, len(u)) * 0.5
    side = ref_als.Side(u, i, r, 31, "cpu", big=64)
    F = rng.standard_normal((12, 3))
    got = side.half(torch.as_tensor(F), 0.01, slots=256).numpy()
    want = _dense_half(u, i, r, 31, F, 0.01)
    assert np.abs(got - want).max() < 1e-10
    assert not got[30].any()


def test_als_train_and_objective():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 20, 300).astype(np.int32)
    i = rng.integers(0, 9, 300).astype(np.int32)
    r = (rng.integers(1, 11, 300) * 0.5).astype(np.float32)
    R = ref_als.Ratings(u, i, r, 20, 9, "cpu")
    V0 = rng.standard_normal((9, 4)) / 2
    U, V = R.train(V0, 3, 0.01)
    Vd = V0.copy()
    for _ in range(3):
        Ud = _dense_half(u, i, r.astype(np.float64), 20, Vd, 0.01)
        Vd = _dense_half(i, u, r.astype(np.float64), 9, Ud, 0.01)
    assert np.abs(U.numpy() - Ud).max() < 1e-9 and np.abs(V.numpy() - Vd).max() < 1e-9
    want = (((Ud[u] * Vd[i]).sum(1) - r) ** 2).sum() + 0.01 * (
        (np.bincount(u, minlength=20) * (Ud ** 2).sum(1)).sum()
        + (np.bincount(i, minlength=9) * (Vd ** 2).sum(1)).sum())
    assert abs(R.objective(U, V, 0.01) - want) < 1e-8 * want
    assert ref_als.normal_equations_err(R.items, U, V, 0.01) < 1e-12


def test_tower64_matches_numpy():
    rng = np.random.default_rng(2)
    p = {"params": {"Embed_0": {"embedding": rng.standard_normal((10, 4)).astype(np.float32)},
                    "Dense_0": {"kernel": rng.standard_normal((4, 6)).astype(np.float32),
                                "bias": rng.standard_normal(6).astype(np.float32)},
                    "Dense_1": {"kernel": rng.standard_normal((6, 4)).astype(np.float32),
                                "bias": rng.standard_normal(4).astype(np.float32)}}}
    P = {k: {n: v.astype(np.float64) for n, v in d.items()} for k, d in p["params"].items()}
    x = P["Embed_0"]["embedding"][[3, 5]]
    x = np.maximum(x @ P["Dense_0"]["kernel"] + P["Dense_0"]["bias"], 0)
    x = x @ P["Dense_1"]["kernel"] + P["Dense_1"]["bias"]
    x = x / (1e-8 + np.linalg.norm(x, axis=1, keepdims=True))
    assert np.abs(ref_tt.tower64(p, [3, 5], "cpu").numpy() - x).max() < 1e-12


def _index(n=200, m=2, K=8, dsub=2, seed=3):
    rng = np.random.default_rng(seed)
    cb = rng.standard_normal((m, K, dsub)).astype(np.float32)
    codes = rng.integers(0, K, (n, m)).astype(np.uint8)
    return cb, codes


def test_replay_shortlist_sets():
    cb, codes = _index()
    idx = ref_tt.Index(cb, codes, "cpu")
    q = torch.as_tensor(np.random.default_rng(4).standard_normal(4))
    rep = ref_tt.Replay(q, idx, 10)
    adc = rep.adc.numpy()
    order = np.argsort(-adc, kind="stable")
    # the clear top items are sure; a clear bottom item is not possible
    assert set(rep.sure) <= set(order[:10].tolist())
    assert not rep.possible(int(order[-1]))
    assert all(rep.possible(int(j)) for j in rep.sure)


def test_judge_scores_and_faults():
    cb, codes = _index()
    idx = ref_tt.Index(cb, codes, "cpu")
    rng = np.random.default_rng(5)
    V = torch.as_tensor(rng.standard_normal((200, 4)))
    q = torch.as_tensor(rng.standard_normal(4))
    rep = ref_tt.Replay(q, idx, 50)
    exact = (V @ q).numpy()
    sure = sorted(rep.sure, key=lambda j: -exact[j])[:3]
    f, s, g = ref_tt.judge(sure, [exact[j] for j in sure], q, V, rep, 3)
    assert s < 1e-12 and g == 0.0 and f == 0
    bad = [sure[0], sure[2], sure[1]]
    f, s, g = ref_tt.judge(bad, [exact[j] for j in bad], q, V, rep, 3)
    assert g > 0 and f >= 1
    f, s, g = ref_tt.judge(sure[:2], [exact[j] for j in sure[:2]], q, V, rep, 3)
    assert f == 1
    off = [exact[j] for j in sure]
    off[1] += 1e-4
    f, s, g = ref_tt.judge(sure, off, q, V, rep, 3)
    assert f == 1 and s > 9e-5


def test_nearest_codes_miss():
    cb, _ = _index(K=16)
    idx = ref_tt.Index(cb, np.zeros((5, 2), np.uint8), "cpu")
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((40, 4)))
    xs = x.reshape(40, 2, 2).transpose(0, 1)
    d = (idx.cb.pow(2).sum(-1)[:, None, :] - 2 * torch.bmm(xs, idx.cb.transpose(1, 2)))
    best = d.argmin(-1).T
    assert ref_tt.nearest_codes_miss(x, best, idx) == 0
    wrong = best.clone()
    wrong[3, 0] = (wrong[3, 0] + 1) % 16
    assert ref_tt.nearest_codes_miss(x, wrong, idx) == 1


def test_lloyd64_matches_a_plain_loop():
    rng = np.random.default_rng(7)
    V = rng.standard_normal((500, 4)).astype(np.float32)
    got = ref_tt.lloyd64(V, 2, 6, 3, 11, 300, "cpu", chunk=64).numpy()
    r = np.random.default_rng(11)
    X = V[r.choice(500, size=300, replace=False)].astype(np.float64)
    C = X[r.choice(300, size=6, replace=False)].reshape(6, 2, 2).transpose(1, 0, 2).copy()
    for _ in range(3):
        for s in range(2):
            x = X[:, 2 * s:2 * s + 2]
            a = ((x[:, None, :] - C[s][None]) ** 2).sum(-1).argmin(1)
            for j in range(6):
                if (a == j).any():
                    C[s, j] = x[a == j].mean(0)
    assert np.abs(got - C).max() < 1e-12
