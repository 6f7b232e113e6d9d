"""Product-quantization codebook training + corpus encoding (PyTorch).

The index-build half of the ANN subsystem, the port's copy of the JAX
package's ``ann/pq.py``: split the embedding dimension into ``m``
subspaces, train ``k ≤ 256`` centroids per subspace with a few Lloyd
iterations on the device (sample-bounded), and encode the full item
corpus to (N, m) uint8 code words. Training runs at ``pio train`` time —
the codebooks travel inside the model artifact (see
:mod:`predictionio_tpu_torch.ann.index`), never rebuilt at serve time.

The sample, the initial centroids and the jitter come from
``np.random.default_rng(seed)`` drawn exactly as the JAX package draws
them, so both packages start Lloyd from the same centroids. Memory
discipline: the Lloyd assignment tensor is (m, chunk, K) — the sample is
scanned in fixed chunks, and encoding chunks the corpus the same way.
The assignment sums are one-hot matrix products (no atomics), so a build
is the same on every run. torch loads inside the functions that run on
the device; :func:`decode` and :func:`reconstruction_mse` (without
``codes``: it encodes) are host numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_LLOYD_CHUNK = 8192    # sample rows per assignment step
_ENCODE_CHUNK = 65536  # corpus rows per encode step (the result does not depend on it)


def _lloyd(Xc, w, C0, *, iters: int):
    """``Xc``: (S, m, T, dsub) chunked sample, ``w``: (S, T) row
    validity (0.0 pad), ``C0``: (m, K, dsub) initial centroids; all on
    one device. Returns the (m, K, dsub) centroids."""
    import torch

    C = C0
    m, K, _ = C0.shape
    for _ in range(iters):
        sums = torch.zeros_like(C)
        cnt = torch.zeros((m, K), dtype=C.dtype, device=C.device)
        cn = (C * C).sum(-1)                                  # (m, K)
        for x, wv in zip(Xc, w):                              # (m,T,d), (T,)
            d = cn[:, None, :] - 2.0 * torch.bmm(x, C.transpose(1, 2))
            a = d.argmin(-1)                                  # (m, T)
            oh = torch.zeros((m, x.shape[1], K), dtype=x.dtype,
                             device=x.device)
            oh.scatter_(2, a[..., None], wv[None, :, None].expand(m, -1, 1))
            sums += torch.bmm(oh.transpose(1, 2), x)
            cnt += oh.sum(1)
        # empty clusters keep their previous centroid (standard Lloyd
        # degeneracy handling; with sampled init they stay rare)
        C = torch.where(cnt[..., None] > 0.5,
                        sums / torch.clamp(cnt, min=1.0)[..., None], C)
    return C


def _check_geometry(dim: int, m: int, k: int) -> int:
    if m < 1 or dim % m:
        raise ValueError(
            f"embedding dim {dim} must split evenly into m={m} subspaces")
    if not 2 <= k <= 256:
        raise ValueError(f"PQ k={k} out of range [2, 256] (codes are uint8)")
    return dim // m


def train_codebooks(V, m: int, k: int, *, iters: int = 8, seed: int = 0,
                    sample: int = 65536, device=None) -> np.ndarray:
    """Train (m, k, dim/m) PQ codebooks over item embeddings ``V`` on
    ``device`` (CUDA unless the caller names another).

    Lloyd k-means per subspace, all subspaces batched; at most
    ``sample`` corpus rows participate (uniform without replacement) so
    build time is corpus-size-independent past the sample. Centroids
    are seeded from distinct sampled rows; when the corpus has fewer
    than ``k`` rows the remainder is jittered copies (those clusters go
    empty and just hold their centroid).
    """
    import torch

    from predictionio_tpu_torch.utils.device import full_f32, resolve_device

    dev = resolve_device(device)
    V = np.asarray(V, np.float32)
    n, dim = V.shape
    dsub = _check_geometry(dim, m, k)
    rng = np.random.default_rng(seed)
    if n > sample:
        X = V[rng.choice(n, size=sample, replace=False)]
    else:
        X = V
    # (m, n_sample, dsub): subspace-major so every per-subspace op is a
    # leading-axis batch
    Xs = np.ascontiguousarray(
        X.reshape(len(X), m, dsub).transpose(1, 0, 2))
    if len(X) >= k:
        C0 = Xs[:, rng.choice(len(X), size=k, replace=False), :]
    else:
        picks = rng.choice(len(X), size=k, replace=True)
        C0 = Xs[:, picks, :] + rng.normal(
            0, 1e-3, size=(m, k, dsub)).astype(np.float32)
    # chunk the sample for the assignment step
    T = min(_LLOYD_CHUNK, max(len(X), 1))
    pad = -len(X) % T
    w = np.concatenate([np.ones(len(X), np.float32),
                        np.zeros(pad, np.float32)])
    if pad:
        Xs = np.concatenate(
            [Xs, np.zeros((m, pad, dsub), np.float32)], axis=1)
    S = Xs.shape[1] // T
    Xc = np.ascontiguousarray(
        Xs.reshape(m, S, T, dsub).transpose(1, 0, 2, 3))
    with full_f32():
        C = _lloyd(torch.from_numpy(Xc).to(dev),
                   torch.from_numpy(w.reshape(S, T)).to(dev),
                   torch.from_numpy(np.ascontiguousarray(C0, np.float32)).to(dev),
                   iters=iters)
    return C.cpu().numpy()


def train_opq(V, m: int, k: int, *, iters: int = 8, opq_iters: int = 4,
              seed: int = 0, sample: int = 65536, device=None,
              timings: Optional[dict] = None):
    """OPQ-style learned rotation + codebooks: alternate Lloyd codebook
    training with an orthogonal-Procrustes rotation update so the
    subspace split aligns with the corpus' principal structure —
    recall at a given M (i.e. at the same code bytes per item), or the
    same recall at lower M.

    Returns ``(rotation (dim, dim) f32, codebooks (m, k, dim/m) f32)``.
    The rotation is orthogonal, so inner products are preserved
    exactly: ``q·v == (qR)·(vR)`` — serving rotates the query once
    before the ADC LUT and re-ranks against the UN-rotated float
    corpus, identical contract to plain PQ.

    Each OPQ iteration: train codebooks on the rotated sample, encode +
    reconstruct, then solve ``min_R ||X R − recon||_F`` over orthogonal
    R in closed form (SVD of ``Xᵀ·recon``, numpy float64). A final
    codebook pass on the converged rotation keeps codebooks and rotation
    consistent. ``opq_iters=0`` degrades to plain PQ with an identity
    rotation. ``timings`` (a dict) accumulates the seconds of the Lloyd
    passes and the encodes under ``lloyd_sec`` and ``encode_sec``.
    """
    import time

    timings = {} if timings is None else timings
    timings.setdefault("lloyd_sec", 0.0)
    timings.setdefault("encode_sec", 0.0)
    V = np.asarray(V, np.float32)
    n, dim = V.shape
    _check_geometry(dim, m, k)
    rng = np.random.default_rng(seed)
    if n > sample:
        X = V[rng.choice(n, size=sample, replace=False)]
    else:
        X = V
    R = np.eye(dim, dtype=np.float32)
    for _ in range(max(0, int(opq_iters))):
        Xr = X @ R
        t0 = time.perf_counter()
        C = train_codebooks(Xr, m, k, iters=iters, seed=seed,
                            sample=len(X), device=device)
        t1 = time.perf_counter()
        codes = encode(Xr, C, device=device)
        timings["lloyd_sec"] += t1 - t0
        timings["encode_sec"] += time.perf_counter() - t1
        recon = decode(codes, C)
        # orthogonal Procrustes in f64: the SVD of a near-singular
        # cross-covariance is where f32 visibly degrades orthogonality
        M = (X.astype(np.float64).T @ recon.astype(np.float64))
        Uo, _s, Vt = np.linalg.svd(M)
        R = (Uo @ Vt).astype(np.float32)
    t0 = time.perf_counter()
    codebooks = train_codebooks(X @ R, m, k, iters=iters, seed=seed,
                                sample=len(X), device=device)
    timings["lloyd_sec"] += time.perf_counter() - t0
    return R, codebooks


def encode(V, codebooks: np.ndarray, device=None) -> np.ndarray:
    """Encode the corpus to (N, m) uint8 nearest-centroid code words on
    ``device``, in chunks of rows."""
    import torch

    from predictionio_tpu_torch.utils.device import full_f32, resolve_device

    dev = resolve_device(device)
    V = np.asarray(V, np.float32)
    n, dim = V.shape
    m, k, dsub = codebooks.shape
    if dim != m * dsub:
        raise ValueError(f"corpus dim {dim} != codebook dim {m * dsub}")
    C = torch.tensor(np.asarray(codebooks, np.float32), device=dev)
    Ct = C.transpose(1, 2)                                    # (m, dsub, K)
    cn = (C * C).sum(-1)                                      # (m, K)
    out = np.empty((n, m), np.uint8)
    with full_f32():
        for lo in range(0, n, _ENCODE_CHUNK):
            x = torch.from_numpy(V[lo:lo + _ENCODE_CHUNK]).to(dev)
            x = x.reshape(-1, m, dsub).transpose(0, 1)        # (m, T, dsub)
            d = cn[:, None, :] - 2.0 * torch.bmm(x, Ct)       # (m, T, K)
            out[lo:lo + x.shape[1]] = (
                d.argmin(-1).T.to(torch.uint8).cpu().numpy())
    return out


def decode(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Reconstruct (N, dim) float approximations from code words —
    used by OPQ, round-trip tests and recall diagnostics, not serving."""
    cb = np.asarray(codebooks, np.float32)
    cd = np.asarray(codes)
    return np.concatenate(
        [cb[mi][cd[:, mi]] for mi in range(cb.shape[0])], axis=1)


def reconstruction_mse(V, codebooks: np.ndarray,
                       codes: Optional[np.ndarray] = None,
                       device=None) -> float:
    """Mean squared quantization error of the corpus (diagnostic)."""
    V = np.asarray(V, np.float32)
    if codes is None:
        codes = encode(V, codebooks, device=device)
    err = V - decode(codes, codebooks)
    return float(np.mean(err * err))
