#!/usr/bin/env python3
"""Smoke run of the PyTorch and CUDA port (predictionio_tpu_torch) on one card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # phases 1-3: build and check the four kernels
    python3 chip_smoke.py --profile  # also device time by kernel (torch.profiler)
                                     # of serving batches and a training iteration

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. the card's name and power limit (nvidia-smi);
2. build every kernel (``predictionio_tpu_torch/csrc/*.cu``) for sm_90a,
   one nvcc per source, all started together; print each build time and
   ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card
   (PyTorch's default f32 matmuls, no TF32): score_topk — equal indices on integer data, values within
   rtol/atol 1e-5 and indices equal up to near-ties on Gaussian data, pad
   rows exact; gather_gram — bitwise equal on integer data, within 1e-5 of
   a float64 reference (relative to max|A64|) on Gaussian data, A exactly
   symmetric, f32 and bf16 factors, repeated indices, pad slots, every
   path of its plan (narrow rows packed, wide rows split), all-zero rows,
   zero runs mid-row, an F off the 16-byte boundary, R = 0; chol_solve — within 1e-4 of
   float64 (relative to max|x64|) on ALS-like SPD systems and on the same
   systems ill-scaled, at every KP boundary of k = 1 … 128, identity
   systems give x = b exactly; rows_gram — bitwise equal on integer data
   (A symmetric), within 1e-5 of a float64 reference on Gaussian data
   with 20% zero weights, pad at the end of each row and runs of zero
   weights mid-row, at every width of the training layout's ladder, f32
   and bf16 blocks, R = 0;
4. time score_topk with CUDA events at the serving path's shapes, beside
   its plain version, one library call and the card's bound;
5. full-width training: a synthetic MovieLens-20M-shaped COO (138,493
   users x 26,744 items, 20,000,263 ratings, power-law popularity), the
   host layout (als_prepare), then explicit ALS on the card (rank 64, 10
   iterations, lambda 0.01, weighted lambda) with TF32 turned on for the
   process, so that the port's own guard is what keeps the dense head's
   matmuls at full f32, and with the launch counters zeroed just before
   and read just after; the final factors are held against their
   float64 normal equations built from the raw COO (64 items given the
   final U, 64 users given the second-to-last V), and the final U
   half-step, rerun without TF32, must equal the final U bitwise; two
   controls rerun the last iteration with less precision (bf16 gathers;
   TF32 in the dense head with the guard taken out) and must fail the
   float64 check and move U, which shows those checks can tell them from
   the f32 run;
6. time gather_gram for every bucket of that layout (with its padded,
   rated and modelled multiplied slots and its plan; each result within
   1e-5 of float64 and exactly symmetric, and a packed bucket also timed
   with one row a block, which must give the same bits) and chol_solve at
   both sides' N, beside the plain versions, one library call and the
   bound (the larger of the bytes and the operations the function needs,
   per launch, summed over the launches); then drive rows_gram's path,
   its op entry point, over every bucket pre-gathered as F[idx] in row
   chunks (launch counters zeroed just before and read just after, each
   result within 1e-5 of a float64 reference on the same inputs, the
   plain version's distance from it printed beside), and time it the same
   way, beside gather_gram on the same rows;
7. ``pio train`` through the port's CLI in a subprocess on the card, on
   200,000 rate events written into a temporary PIO_HOME through the
   port's storage; the COMPLETED instance is deployed and 20 answers are
   checked against the plain reference;
8. the factors phase 5 trained, written as a COMPLETED Recommendation
   engine instance into a temporary PIO_HOME through the port's storage,
   deployed with the port's EngineServer (micro-batching, AOT ladder);
   sequential and concurrent POST /queries.json, every answer checked
   against the plain reference on the card; the launch counters are
   zeroed just before the queries and score_topk must have grown.

Each phase prints its wall time. The line before the last is a JSON
object with each kernel's numbers; the last line is {"ok": true,
"device": {...}}. Any failed phase exits non-zero before either is
printed. Without a CUDA card the script exits non-zero at once.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

# ML-20M serving geometry (BASELINE.md protocol)
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
TILE = 2048
N_PAD = -(-N_ITEMS // TILE) * TILE          # 28,672 resident item rows
BATCH_MAX, AOT_TOPK = 64, 16
SEED = 0
# full-width training: the template's defaults at BASELINE.md's rank
N_RATINGS, ITERATIONS, LAMBDA = 20_000_263, 10, 0.01
# `pio train` through the CLI: a small app from the same generator
APP_EVENTS, APP_USERS, APP_ITEMS = 200_000, 10_000, 2_000

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

TOL = 1e-5
GRAM_TOL = 1e-5    # gather_gram: max|dA| / max|A64| on Gaussian data
SOLVE_TOL = 1e-4   # chol_solve: max|x - x64| / max|x64|
ORACLE_TOL = 1e-3  # trained factors against their float64 normal equations


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


_PHASE_T0 = [0.0]


def phase(name: str) -> None:
    now = time.perf_counter()
    if _PHASE_T0[0]:
        print(f"-- phase wall time {now - _PHASE_T0[0]:.1f} s", flush=True)
    _PHASE_T0[0] = now
    print(f"== {name}", flush=True)


def synthetic_ml20m(nnz: int, n_users: int, n_items: int, seed: int = 7):
    """Power-law user/item popularity, Zipf-ish, like MovieLens (the
    benchmark's generator)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u_pop = rng.zipf(1.35, size=nnz * 2) % n_users
    i_pop = rng.zipf(1.25, size=nnz * 2) % n_items
    users = u_pop[:nnz].astype(np.int32)
    items = i_pop[:nnz].astype(np.int32)
    ratings = (rng.integers(1, 11, size=nnz) * 0.5).astype(np.float32)
    return users, items, ratings


def score_topk_bound_ms(B: int, d: int, np_: int, k: int):
    flop_s = 2 * B * d * np_ / PEAK_F32_FLOPS
    byte_s = 4 * (B * d + np_ * d + 2 * B * k) / PEAK_HBM_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s >= byte_s else "bytes")


def cuda_ms(fn, iters: int = 50, warmup: int = 5):
    """(device ms, per-call ms) of ``fn``, from CUDA events.

    Device time: the stream is first held by a spin kernel long enough
    for the host to enqueue every iteration, so the events bracket the
    launches back to back and host overhead drops out. Per-call time:
    the same loop without the spin, so a call whose host side is slower
    than its kernels is timed at its host rate — what a caller pays."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for hold in (True, False):
        if hold:  # ~2 GHz clock: spin three times the host's enqueue time
            torch.cuda._sleep(int(host_s * 3 * 2e9) + 1_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out[0], out[1]


def profile_score_topk(torch, ops, dev) -> None:
    """--profile: device time by kernel name from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    U = torch.randn(N_USERS, RANK, generator=g, device=dev)
    Vp = torch.randn(N_PAD, RANK, generator=g, device=dev)
    for B in (1, 64):
        ids = torch.randint(0, N_USERS, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        call = lambda: ops.score_topk(U, Vp, AOT_TOPK, n_valid=N_ITEMS, ids=ids)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            if dev_us and ev.count:
                print(f"profile B={B:2d} {ev.key[:60]:60s} calls={ev.count:3d} "
                      f"device_us_per_call={dev_us / ev.count:.2f}", flush=True)


def topk_agrees(vals, idx, ref_vals, ref_idx, scores64) -> bool:
    """Values within rtol/atol 1e-5; indices equal except where the two
    candidates' float64 scores lie within 1e-5 of each other."""
    import torch

    if not torch.allclose(vals, ref_vals, rtol=TOL, atol=TOL):
        return False
    diff = idx != ref_idx
    if not bool(diff.any()):
        return True
    got = torch.gather(scores64, 1, idx.long())
    want = torch.gather(scores64, 1, ref_idx.long())
    return bool(((got - want).abs()[diff] <= TOL).all())


def check_score_topk(torch, ops, dev) -> float:
    """Phase 3: the kernel against score_topk_ref; returns the max abs
    value error at the serving path's shape (B=64, k=16, Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    main_err = None
    for kind in ("integer", "gaussian"):
        if kind == "integer":
            # nonzero small integers: every score is exact in f32
            def draw(*shape):
                mag = torch.randint(1, 4, shape, generator=g, device=dev)
                sign = torch.randint(0, 2, shape, generator=g, device=dev) * 2 - 1
                return (mag * sign).float()
        else:
            def draw(*shape):
                return torch.randn(*shape, generator=g, device=dev)
        U = draw(N_USERS, RANK)
        V = draw(N_ITEMS, RANK)
        Vp = torch.cat([V, torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
        for B in (1, 16, 64, 256):
            ids = torch.randint(0, N_USERS, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            rows_valid = B - B // 4
            for k in (16, 128, 1024):
                vals, idx = ops.score_topk(U, Vp, k, n_valid=N_ITEMS,
                                           rows_valid=rows_valid, ids=ids)
                rv, ri = ops.score_topk_ref(U, Vp, k, n_valid=N_ITEMS,
                                            rows_valid=rows_valid, ids=ids)
                torch.cuda.synchronize()
                err = (vals - rv).abs().max().item()
                if kind == "integer":
                    ok = torch.equal(idx, ri) and torch.equal(vals, rv)
                else:
                    s64 = U[ids.long()].double() @ Vp.double().T
                    s64[rows_valid:] = 0.0
                    s64[:, N_ITEMS:] = -3.0e38
                    ok = topk_agrees(vals[:rows_valid], idx[:rows_valid],
                                     rv[:rows_valid], ri[:rows_valid],
                                     s64[:rows_valid])
                pad_ok = bool((vals[rows_valid:] == 0).all()) and bool(
                    (idx[rows_valid:] == torch.arange(k, device=dev)).all())
                print(f"score_topk {kind:8s} B={B:3d} d={RANK} Np={N_PAD} "
                      f"k={k:4d} rows_valid={rows_valid:3d} "
                      f"max_abs_err={err:.3e} "
                      f"{'ok' if ok and pad_ok else 'MISMATCH'}", flush=True)
                check(ok, f"score_topk disagrees with score_topk_ref "
                          f"({kind}, B={B}, k={k})")
                check(pad_ok, f"score_topk pad rows wrong (B={B}, k={k})")
                if kind == "gaussian" and B == BATCH_MAX and k == AOT_TOPK:
                    main_err = err
                    # a row's answer does not depend on its batch: the
                    # padded bucket and the row alone agree bitwise
                    for r in (0, 1, rows_valid - 1):
                        v1, i1 = ops.score_topk(U, Vp, k, n_valid=N_ITEMS,
                                                ids=ids[r:r + 1])
                        check(torch.equal(v1[0], vals[r])
                              and torch.equal(i1[0], idx[r]),
                              f"row {r} differs between B={B} and B=1")
    return main_err


def _row_chunks(R: int, per_row: int, limit: int = 1 << 26):
    """Row slices whose gathered block stays under ``limit`` elements."""
    step = max(1, limit // max(1, per_row))
    return [slice(s, min(s + step, R)) for s in range(0, R, step)]


def gram64(torch, F, idx, wo, wb):
    """Float64 reference of gather_gram, in row chunks (order-free)."""
    R, C = idx.shape
    k = F.shape[1]
    A = torch.empty((R, k, k), dtype=torch.float64, device=F.device)
    b = torch.empty((R, k), dtype=torch.float64, device=F.device)
    F64 = F.double()
    for sl in _row_chunks(R, C * k):
        G = F64[idx[sl].long()]
        A[sl] = torch.einsum("rc,rck,rcl->rkl", wo[sl].double(), G, G)
        b[sl] = torch.einsum("rc,rck->rk", wb[sl].double(), G)
    return A, b


def gram_plain(torch, ops, F, idx, wo, wb):
    """gather_gram_ref over row chunks (rows are independent), so the
    largest shapes fit on the card."""
    parts = [ops.gather_gram_ref(F, idx[sl], wo[sl], wb[sl])
             for sl in _row_chunks(idx.shape[0], idx.shape[1] * F.shape[1])]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


def gram_inputs(torch, g, dev, R, C, k, kind, n_f=N_ITEMS, holes=False):
    """F, idx, wo, wb like a bucket's: odd rows draw their indices from 16
    rows (many repeats), the last quarter of each row is pad (index 0,
    weight 0). With ``holes``, every third row from the first also has a
    run of zero weights mid-row (whole tiles to skip at wide C) and every
    fifth row from the third has no nonzero weight at all. Integer data is exact in f32 whatever
    the summation order."""
    if kind == "integer":
        F = torch.randint(-3, 4, (n_f, k), generator=g, device=dev).float()
        wo = torch.randint(0, 4, (R, C), generator=g, device=dev).float()
        wb = torch.randint(-3, 4, (R, C), generator=g, device=dev).float()
    else:
        F = torch.randn(n_f, k, generator=g, device=dev)
        wo = torch.rand(R, C, generator=g, device=dev) * 2
        wo[torch.rand(R, C, generator=g, device=dev) < 0.2] = 0.0
        wb = torch.randn(R, C, generator=g, device=dev)
    idx = torch.randint(0, n_f, (R, C), generator=g, device=dev, dtype=torch.int32)
    idx[1::2] = torch.randint(0, 16, idx[1::2].shape, generator=g, device=dev,
                              dtype=torch.int32)
    pad = C - C // 4 if C >= 4 else C
    idx[:, pad:] = 0
    wo[:, pad:] = 0.0
    wb[:, pad:] = 0.0
    if holes:
        wo[::3, C // 8:C // 2] = 0.0
        wb[::3, C // 8:C // 2] = 0.0
        wo[2::5] = 0.0
        wb[2::5] = 0.0
    return F, idx, wo.contiguous(), wb.contiguous()


def misaligned(torch, F):
    """A contiguous copy of F that starts one element past a 16-byte
    boundary (a view into a larger buffer), so the kernel cannot take its
    16-byte copies."""
    buf = torch.empty(F.numel() + 1, dtype=F.dtype, device=F.device)
    out = buf[1:].view(F.shape)
    out.copy_(F)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def check_gather_gram(torch, ops, dev) -> float:
    """Phase 3: gather_gram against gather_gram_ref (bitwise on integer
    data) and a float64 reference (max|dA| / max|A64| <= 1e-5 on Gaussian
    data), f32 and bf16 factors; A exactly symmetric on every kind of
    data. Beside the first cases, every path of the kernel's plan: narrow
    rows packed several to a block with R not a multiple of the rows a
    block takes, wide rows split into chunks (C = 8,192 at R = 1, 42 and
    384), rows whose weights are all zero, zero runs mid-row, and an F
    that is not 16-byte aligned, and the training layout's bucket heights
    (R = 6,144, 19,813, 105,312), whose plans pack up to 8 rows. Returns the max abs error against the
    plain version at the training path's width (k=64, C=2048, Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    main_err = 0.0
    # (k, C, R, dtype, holes, aligned)
    cases = [(k, C, R, torch.float32, False, True) for k in (8, 10, RANK, 128)
             for C in (8, 128, 2048, 8192) for R in (1, 13, 4096)]
    cases += [(k, C, 13, torch.bfloat16, False, True) for k in (10, RANK)
              for C in (128, 2048)]
    dtypes = (torch.float32, torch.bfloat16)
    # packed narrow rows (R = 4097: the last block takes fewer rows)
    cases += [(k, C, R, dt, True, True) for k in (10, RANK, 128) for C in (8, 32)
              for R in (1, 7, 4097) for dt in dtypes]
    # the training layout's bucket heights, so every packing it runs is held
    # here too (the user C = 8 bucket's 105,312 rows take the most)
    cases += [(RANK, C, R, dt, True, True) for C in (8, 32, 128, 512)
              for R in (6144, 19813) for dt in dtypes]
    cases += [(RANK, 8, 105312, torch.float32, True, True)]
    # split wide rows: the seg bucket's 42 rows and the 384 of C = 8,192
    cases += [(k, 8192, R, dt, True, True) for k in (10, RANK, 128) for R in (1, 42)
              for dt in dtypes]
    cases += [(RANK, 8192, 384, dt, True, True) for dt in dtypes]
    # an F off the 16-byte boundary: the plain-load route at every plan
    cases += [(k, C, R, dt, True, False) for k in (RANK, 128) for C, R in
              ((8, 4097), (512, 13), (8192, 42)) for dt in dtypes]
    for k, C, R, dtype, holes, aligned in cases:
        for kind in ("integer", "gaussian"):
            F, idx, wo, wb = gram_inputs(torch, g, dev, R, C, k, kind, holes=holes)
            F = F.to(dtype)
            if not aligned:
                F = misaligned(torch, F)
            A, b = ops.gather_gram(F, idx, wo, wb)
            Ar, br = gram_plain(torch, ops, F, idx, wo, wb)
            torch.cuda.synchronize()
            err = max((A - Ar).abs().max().item(), (b - br).abs().max().item())
            if kind == "integer":
                ok = torch.equal(A, Ar) and torch.equal(b, br)
                rel = 0.0
            else:
                A64, b64 = gram64(torch, F.float(), idx, wo, wb)
                rel = max(((A.double() - A64).abs().max()
                           / A64.abs().max().clamp_min(1e-300)).item(),
                          ((b.double() - b64).abs().max()
                           / b64.abs().max().clamp_min(1e-300)).item())
                ok = rel <= GRAM_TOL
                if k == RANK and C == 2048 and dtype == torch.float32 and not holes:
                    main_err = max(main_err, err)
                del A64, b64
            # A is mirrored from one triangle: symmetric on any data
            sym = torch.equal(A, A.transpose(1, 2))
            plan = ops.gram.gram_plan(R, C)
            print(f"gather_gram {kind:8s} {str(dtype)[6:]:8s} k={k:3d} C={C:4d} "
                  f"R={R:6d} split={plan.split} rows/block={plan.rows_per_block}"
                  f"{' holes' if holes else ''}{'' if aligned else ' unaligned F'} "
                  f"max_abs_err={err:.3e} rel64={rel:.3e} "
                  f"{'ok' if ok and sym else 'MISMATCH'}", flush=True)
            check(ok, f"gather_gram disagrees ({kind}, {dtype}, k={k}, C={C}, R={R})")
            check(sym, f"gather_gram A not symmetric ({kind}, k={k}, C={C}, R={R})")
            del F, idx, wo, wb, A, b, Ar, br
    for dtype in dtypes:
        A, b = ops.gather_gram(torch.zeros(5, RANK, device=dev, dtype=dtype),
                               torch.zeros(0, 8, device=dev, dtype=torch.int32),
                               torch.zeros(0, 8, device=dev), torch.zeros(0, 8, device=dev))
        check(A.shape == (0, RANK, RANK) and b.shape == (0, RANK),
              f"gather_gram R=0 ({dtype}) gave {tuple(A.shape)}, {tuple(b.shape)}")
    print("gather_gram R=0 (f32, bf16): empty outputs of the right shape, no launch",
          flush=True)
    return main_err


def multiplied_slots(torch, wo, wb, tile: int) -> int:
    """Slots the kernel gathers and multiplies, modelled from its rule (it
    counts nothing itself): in each tile of ``tile`` slots, those up to
    its last slot of nonzero weight. Exact for unsplit rows; a split
    chunk starts a tile of its own."""
    R, C = wo.shape
    live = torch.zeros((R, -(-C // tile) * tile), dtype=torch.bool, device=wo.device)
    live[:, :C] = (wo != 0) | (wb != 0)
    pos = torch.arange(1, tile + 1, device=wo.device)
    return int((live.view(R, -1, tile) * pos).amax(-1).sum().item())


def rows_gram_plain(torch, ops, F_g, wo, wb):
    """rows_gram_ref over row chunks (rows are independent), so the
    largest shapes fit on the card."""
    parts = [ops.rows_gram_ref(F_g[sl], wo[sl], wb[sl])
             for sl in _row_chunks(F_g.shape[0], F_g.shape[1] * F_g.shape[2])]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


def check_rows_gram(torch, ops, dev) -> float:
    """Phase 3: rows_gram against rows_gram_ref (bitwise on integer data,
    A symmetric) and a float64 reference (max|dA| / max|A64| <= 1e-5 on
    Gaussian data with 20% zero weights), f32 and bf16 F_g, R = 0. The
    blocks are gather_gram's inputs gathered, F_g = F[idx] (repeated rows,
    a quarter of pad slots), so gram64 is the float64 reference. Returns
    the max abs error against the plain version at the training path's
    width (k=64, W=128, R=4096, Gaussian)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    main_err = 0.0
    cases = [(k, W, R, torch.float32) for k in (3, 8, RANK, 128)
             for W in (1, 16, 128, 2048) for R in (1, 20, 4096)]
    # the other widths of the training layout's ladder, at its k
    cases += [(RANK, W, R, torch.float32) for W in (8, 32, 512, 8192)
              for R in (1, 20, 4096)]
    cases += [(k, W, 20, torch.bfloat16) for k in (3, 8, RANK, 128) for W in (16, 2048)]
    for k, W, R, dtype in cases:
        for kind in ("integer", "gaussian"):
            F, idx, wo, wb = gram_inputs(torch, g, dev, R, W, k, kind)
            # every third row also gets a run of zero weights mid-row, so
            # the kernel skips whole tiles and then resumes
            wo[::3, W // 4:W // 2] = 0.0
            wb[::3, W // 4:W // 2] = 0.0
            F = F.to(dtype)
            F_g = F[idx.long()]
            A, b = ops.rows_gram(F_g, wo, wb)
            Ar, br = rows_gram_plain(torch, ops, F_g, wo, wb)
            torch.cuda.synchronize()
            err = max((A - Ar).abs().max().item(), (b - br).abs().max().item())
            if kind == "integer":
                ok = torch.equal(A, Ar) and torch.equal(b, br)
                rel = 0.0
            else:
                A64, b64 = gram64(torch, F.float(), idx, wo, wb)
                rel = max(((A.double() - A64).abs().max()
                           / A64.abs().max().clamp_min(1e-300)).item(),
                          ((b.double() - b64).abs().max()
                           / b64.abs().max().clamp_min(1e-300)).item())
                ok = rel <= GRAM_TOL
                if k == RANK and W == 128 and R == 4096 and dtype == torch.float32:
                    main_err = err
                del A64, b64
            sym = kind != "integer" or torch.equal(A, A.transpose(1, 2))
            print(f"rows_gram {kind:8s} {str(dtype)[6:]:8s} k={k:3d} W={W:4d} "
                  f"R={R:4d} max_abs_err={err:.3e} rel64={rel:.3e} "
                  f"{'ok' if ok and sym else 'MISMATCH'}", flush=True)
            check(ok, f"rows_gram disagrees ({kind}, {dtype}, k={k}, W={W}, R={R})")
            check(sym, f"rows_gram A not symmetric (k={k}, W={W}, R={R})")
            del F, F_g, idx, wo, wb, A, b, Ar, br
    for dtype in (torch.float32, torch.bfloat16):
        A, b = ops.rows_gram(torch.zeros(0, 16, RANK, device=dev, dtype=dtype),
                             torch.zeros(0, 16, device=dev), torch.zeros(0, 16, device=dev))
        check(A.shape == (0, RANK, RANK) and b.shape == (0, RANK),
              f"rows_gram R=0 ({dtype}) gave {tuple(A.shape)}, {tuple(b.shape)}")
    print("rows_gram R=0 (f32, bf16): empty outputs of the right shape, no launch",
          flush=True)
    return main_err


def spd_systems(torch, g, dev, N, k, lam=0.01):
    """ALS-like SPD systems: A = G Gᵀ + λ·n·I with n = 2k rating rows."""
    n = 2 * k
    G = torch.randn(N, k, n, generator=g, device=dev)
    A = torch.bmm(G, G.transpose(1, 2)) + lam * n * torch.eye(k, device=dev)
    b = torch.randn(N, k, generator=g, device=dev)
    return A.contiguous(), b


def check_chol_solve(torch, ops, dev) -> float:
    """Phase 3: chol_solve against float64 and chol_solve_ref at every KP
    boundary of the kernel (k = 1 … 128): ALS-like systems (max|x - x64| /
    max|x64| <= 1e-4 over the batch) and the same systems ill-scaled, each
    multiplied by 10^u, u uniform in [-2, 4) as in the CPU tests (the
    same ratio, taken per system, <= 1e-4); identity systems give x = b
    exactly. Returns the max abs error against the plain version at the
    training path's width (k=64, N=138,493)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    main_err = 0.0
    cases = [(k, N) for k in (1, 7, 8, 10, 16, 31, 33, 63, RANK, 65, 100, 128)
             for N in (1, 255, 4097)] + [(RANK, N_USERS)]
    for k, N in cases:
        A, b = spd_systems(torch, g, dev, N, k)
        x = ops.chol_solve(A, b)
        xr = ops.chol_solve_ref(A, b)
        x64 = torch.linalg.solve(A.double(), b.double())
        torch.cuda.synchronize()
        rel = ((x.double() - x64).abs().max() / x64.abs().max()).item()
        err = (x - xr).abs().max().item()
        # ill-scaled: per system 10^u, u in [-2, 4)
        scale = 10.0 ** (torch.rand(N, 1, 1, generator=g, device=dev) * 6 - 2)
        As = (A * scale).contiguous()
        xs = ops.chol_solve(As, b)
        xs64 = torch.linalg.solve(As.double(), b.double())
        rel_s = ((xs.double() - xs64).abs().amax(1)
                 / xs64.abs().amax(1)).max().item()
        eye = torch.eye(k, device=dev).expand(N, k, k).contiguous()
        exact = torch.equal(ops.chol_solve(eye, b), b)
        ok = rel <= SOLVE_TOL and rel_s <= SOLVE_TOL and exact
        print(f"chol_solve k={k:3d} N={N:6d} rel64={rel:.3e} "
              f"ill_scaled_rel64={rel_s:.3e} max_abs_err(plain)={err:.3e} "
              f"identity_exact={exact} {'ok' if ok else 'MISMATCH'}", flush=True)
        check(rel <= SOLVE_TOL, f"chol_solve off float64 (k={k}, N={N}): {rel:.3e}")
        check(rel_s <= SOLVE_TOL,
              f"chol_solve off float64 on ill-scaled systems (k={k}, N={N}): {rel_s:.3e}")
        check(exact, f"chol_solve identity systems not exact (k={k}, N={N})")
        if k == RANK and N == N_USERS:
            main_err = err
        del A, b, x, xr, x64, As, xs, xs64, eye
    return main_err


def time_score_topk(torch, ops, dev):
    """Phase 4: times at the serving path's shapes (d=64, Np=28,672,
    k=16, every bucket of the default ladder)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    U = torch.randn(N_USERS, RANK, generator=g, device=dev)
    Vp = torch.cat([torch.randn(N_ITEMS, RANK, generator=g, device=dev),
                    torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
    rows = {}
    for B in (1, 2, 4, 8, 16, 32, 64):
        ids = torch.randint(0, N_USERS, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        k = AOT_TOPK
        out = (torch.empty(B, k, device=dev),
               torch.empty(B, k, device=dev, dtype=torch.int32))
        kernel, kernel_call = cuda_ms(lambda: ops.score_topk(
            U, Vp, k, n_valid=N_ITEMS, rows_valid=B, ids=ids, out=out))
        plain, plain_call = cuda_ms(lambda: ops.score_topk_ref(
            U, Vp, k, n_valid=N_ITEMS, rows_valid=B, ids=ids))
        library, library_call = cuda_ms(lambda: torch.topk(
            U[ids.long()] @ Vp[:N_ITEMS].T, k))
        bound, bound_by = score_topk_bound_ms(B, RANK, N_PAD, k)
        rows[B] = {"ms": kernel, "plain_ms": plain, "library_ms": library,
                   "bound_ms": bound, "bound_by": bound_by}
        print(f"score_topk time B={B:2d} k={k} device ms: kernel={kernel:.4f} "
              f"plain={plain:.4f} library(torch.topk)={library:.4f} "
              f"bound={bound:.5f} ({bound_by}); per call ms: "
              f"kernel={kernel_call:.4f} plain={plain_call:.4f} "
              f"library={library_call:.4f}", flush=True)
    return rows


def reset_counters(ops) -> None:
    for c in ops.LAUNCH_COUNTERS:
        c.launches = 0


def read_counters(ops) -> dict:
    return {c.__name__: c.launches for c in ops.LAUNCH_COUNTERS}


def oracle_entities(side, rng, n_heavy: int = 8, n_total: int = 64):
    """Original ids of n_total entities of one side: the heaviest of the
    dense head and the seg bucket (n_heavy in all), the rest drawn by
    seed across the ladder buckets."""
    import numpy as np

    nb_dense = side.dense.nb if side.dense is not None else 0
    segs = [b for b in side.buckets if b.seg is not None]
    nb_seg = segs[0].nb if segs else 0
    half = n_heavy // 2
    pos = list(range(min(half, nb_seg)))
    pos = [nb_dense + p for p in pos]
    pos = list(range(min(n_heavy - len(pos), nb_dense))) + pos
    if len(pos) < n_heavy:  # a short head: more of the seg bucket
        pos += [nb_dense + p for p in range(half, min(nb_seg, half + n_heavy - len(pos)))]
    regs, start = [], nb_dense + nb_seg
    for b in side.buckets:
        if b.seg is None:
            regs.append((b.nb, start))
            start += b.nb
    # smallest buckets first, so a short bucket's share passes to the next
    want = n_total - len(pos)
    for j, (nb, start) in enumerate(sorted(regs)):
        take = min(nb, want // (len(regs) - j))
        pos += [start + int(p) for p in rng.choice(nb, size=take, replace=False)]
        want -= take
    return side.perm[np.asarray(pos, np.int64)]


def normal_equations_err(torch, dev, self_idx, other_idx, rating, F_other,
                         X_self, chosen, lam) -> float:
    """max|X[e] - x64[e]| / max|x64| over ``chosen``, x64 the float64 solve
    of (Σ f fᵀ + λ·n_e·I) x = Σ r f over e's ratings in the raw COO
    (duplicates counted, f the other side's factor rows)."""
    import numpy as np

    sel = np.isin(self_idx, chosen)
    s_idx, o_idx, r = self_idx[sel], other_idx[sel], rating[sel]
    order = np.argsort(s_idx, kind="stable")
    s_idx, o_idx, r = s_idx[order], o_idx[order], r[order]
    F64 = torch.as_tensor(F_other, device=dev).double()
    k = F64.shape[1]
    eye = torch.eye(k, dtype=torch.float64, device=dev)
    diff = scale = 0.0
    for e in chosen:
        lo, hi = np.searchsorted(s_idx, [e, e + 1])
        f = F64[torch.as_tensor(o_idx[lo:hi].astype(np.int64), device=dev)]
        rr = torch.as_tensor(r[lo:hi], device=dev).double()
        A = f.T @ f + max(lam * (hi - lo), 1e-8) * eye
        x = torch.linalg.solve(A, f.T @ rr)
        got = torch.as_tensor(X_self[e], device=dev).double()
        diff = max(diff, (got - x).abs().max().item())
        scale = max(scale, x.abs().max().item())
    return diff / scale


@contextlib.contextmanager
def tf32_matmuls(torch):
    """TF32 allowed for f32 matmuls for the duration (the state a caller
    may leave the process in; the port's training must not depend on it)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def precision_controls(torch, dev, prep, p, coo, U, V9, items_chk, users_chk):
    """Phase 5 controls: the last iteration rerun from the second-to-last
    V with less precision, held against the same float64 normal
    equations as the run itself and against the run's final U — the
    gathers in bf16 (``bf16_gather``), or the dense head's matmuls in
    TF32 with the port's f32 guard taken out. Each must fail the float64
    check (items or users) and move U: the checks can tell it from f32."""
    import numpy as np

    from predictionio_tpu_torch.models import als

    out = {}
    for name, params, guard in (
            ("bf16 gathers", dataclasses.replace(p, iterations=1, bf16_gather=True),
             als._full_f32),
            ("TF32 dense head, guard removed", dataclasses.replace(p, iterations=1),
             contextlib.nullcontext)):
        with tf32_matmuls(torch), mock.patch.object(als, "_full_f32", guard):
            Uc, Vc = als.als_train_prepared(prep, params, device=dev, V0=V9)
        err_v = normal_equations_err(torch, dev, coo.item_idx, coo.user_idx,
                                     coo.rating, Uc, Vc, items_chk, LAMBDA)
        err_u = normal_equations_err(torch, dev, coo.user_idx, coo.item_idx,
                                     coo.rating, V9, Uc, users_chk, LAMBDA)
        rel_u = np.abs(Uc - U).max() / np.abs(U).max()
        out[name] = (err_v, err_u, rel_u)
        print(f"control ({name}): float64 normal equations, items "
              f"{err_v:.3e}, users {err_u:.3e} (the f32 run's limit "
              f"{ORACLE_TOL}); U off the f32 run's final U by {rel_u:.3e} "
              f"(relative to max|U|)", flush=True)
        check(max(err_v, err_u) > ORACLE_TOL and rel_u > 0,
              f"control ({name}) passes the checks the f32 run is held to: "
              f"they cannot tell it from f32")
    return out


def train_full_width(torch, ops, dev) -> dict:
    """Phase 5: the training path at ML-20M width on the card, with TF32
    turned on around it: the port's guard keeps its matmuls at f32."""
    import numpy as np

    from predictionio_tpu_torch.models.als import (ALSParams, RatingsCOO,
                                                   als_prepare,
                                                   als_train_prepared)

    t0 = time.perf_counter()
    users, items, ratings = synthetic_ml20m(N_RATINGS, N_USERS, N_ITEMS)
    coo = RatingsCOO(users, items, ratings, N_USERS, N_ITEMS)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = als_prepare(coo)
    t_prep = time.perf_counter() - t0
    heaviest = {"user": int(np.bincount(users).max()),
                "item": int(np.bincount(items).max())}
    for name, side in (("user", prep.u_side), ("item", prep.i_side)):
        buckets = ", ".join(
            f"{'seg ' if b.seg is not None else ''}C={b.C} nb={b.nb} "
            f"rows={b.n_slabs * b.slab}" for b in side.buckets)
        slots = sum(b.n_slabs * b.slab * b.C for b in side.buckets)
        dense = (f"{side.dense.nb} x {side.dense.n_other}"
                 if side.dense is not None else "none")
        print(f"{name} side: {side.n} entities (heaviest {heaviest[name]} "
              f"ratings), dense head {dense}, {slots} padded slots; "
              f"buckets: {buckets}", flush=True)
    print(f"synthetic COO {N_USERS} x {N_ITEMS}, {coo.nnz} ratings in "
          f"{t_gen:.1f} s; host prep (als_prepare) {t_prep:.1f} s", flush=True)

    p = ALSParams(rank=RANK, iterations=ITERATIONS, reg=LAMBDA,
                  weighted_reg=True, implicit=False, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(ops)
    t0 = time.perf_counter()
    with tf32_matmuls(torch):
        U, V = als_train_prepared(prep, p, device=dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = read_counters(ops)
    print(f"train: {ITERATIONS} iterations rank {RANK} in {t_train:.3f} s "
          f"wall (upload, train, fetch); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
          f"launches {launches}", flush=True)
    for name in ("gather_gram", "chol_solve"):
        check(launches[name] > 0, f"kernel {name} was not launched by training")
    check(np.isfinite(U).all() and np.isfinite(V).all(), "non-finite factors")

    # a second run, timed warm (layout already on the card)
    t0 = time.perf_counter()
    with tf32_matmuls(torch):
        U9, V9 = als_train_prepared(
            prep, dataclasses.replace(p, iterations=ITERATIONS - 1), device=dev)
    torch.cuda.synchronize()
    t_train9 = time.perf_counter() - t0
    # the final U half-step again, from the second-to-last V, at PyTorch's
    # default f32 matmuls: bitwise equal only if TF32 did not reach the
    # dense head of the run above
    U_re, _ = als_train_prepared(prep, dataclasses.replace(p, iterations=0),
                                 device=dev, V0=V9)
    rel_re = np.abs(U_re - U).max() / np.abs(U).max()
    print(f"warm train of {ITERATIONS - 1} iterations {t_train9:.3f} s wall; "
          f"the final U half-step rerun from it without TF32 differs from the "
          f"final U by {rel_re:.3e} (relative to max|U|)", flush=True)
    check(np.array_equal(U_re, U),
          f"rerun U half-step not bitwise the final U: {rel_re:.3e}")

    Ut = torch.as_tensor(U, device=dev)
    Vt = torch.as_tensor(V, device=dev)
    sq = 0.0
    for s in range(0, coo.nnz, 1 << 24):
        uu = torch.as_tensor(users[s:s + (1 << 24)].astype(np.int64), device=dev)
        ii = torch.as_tensor(items[s:s + (1 << 24)].astype(np.int64), device=dev)
        rr = torch.as_tensor(ratings[s:s + (1 << 24)], device=dev)
        sq += ((Ut[uu] * Vt[ii]).sum(1) - rr).double().pow(2).sum().item()
    rmse = (sq / coo.nnz) ** 0.5
    print(f"training RMSE {rmse:.4f} (ratings 0.5..5.0)", flush=True)
    check(rmse < 2.0, f"training RMSE {rmse:.4f} is not that of a fitted model")

    rng = np.random.default_rng(SEED + 5)
    items_chk = oracle_entities(prep.i_side, rng)
    users_chk = oracle_entities(prep.u_side, rng)
    err_v = normal_equations_err(torch, dev, items, users, ratings, U, V,
                                 items_chk, LAMBDA)
    err_u = normal_equations_err(torch, dev, users, items, ratings, V9, U_re,
                                 users_chk, LAMBDA)
    print(f"float64 normal equations: {len(items_chk)} items given the final "
          f"U {err_v:.3e}, {len(users_chk)} users given the second-to-last V "
          f"{err_u:.3e} (max|x - x64| / max|x64|, limit {ORACLE_TOL})", flush=True)
    check(err_v <= ORACLE_TOL, f"items off their normal equations: {err_v:.3e}")
    check(err_u <= ORACLE_TOL, f"users off their normal equations: {err_u:.3e}")
    precision_controls(torch, dev, prep, p, coo, U, V9, items_chk, users_chk)
    return {"prep": prep, "U": U, "V": V, "launches": launches,
            "t_train": t_train, "rmse": rmse}


def profile_training(torch, dev, train) -> None:
    """--profile: device time by kernel of one warm training iteration
    (both half-steps) at the phase-5 layout, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models.als import ALSParams, als_train_prepared

    p = ALSParams(rank=RANK, iterations=1, reg=LAMBDA, seed=SEED)
    als_train_prepared(train["prep"], p, device=dev, V0=train["V"])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        als_train_prepared(train["prep"], p, device=dev, V0=train["V"])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        # kernels only (device-side events), not the host ops launching them
        if dev_us and ev.count and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us, ev.count, ev.key))
    total = sum(r[0] for r in rows)
    print(f"profile: one training iteration (upload of V, both half-steps, "
          f"fetch) {wall:.3f} ms wall, {total / 1e3:.3f} ms of kernels on "
          f"the card", flush=True)
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        print(f"profile train {key[:70]:70s} calls={count:3d} "
              f"device_ms={dev_us / 1e3:.3f} ({100 * dev_us / total:.1f}%)",
              flush=True)


def gram_bound(R: int, C: int, k: int, slots: int, f_rows: int, f_bytes: int = 4):
    """(seconds at the f32 rate, seconds at the memory rate) of the work
    one gather_gram launch needs: per slot of nonzero weight (``slots``)
    k(k+1)/2 FMAs for the lower triangle of the symmetric A, k for w·f and
    k for b; idx, wo and wb read once, each row of F that a slot of
    nonzero weight gathers (``f_rows`` distinct rows) read once, A and b
    written once."""
    flops = slots * (k * k + 5 * k)
    nbytes = 12 * R * C + f_rows * k * f_bytes + 4 * R * (k * k + k)
    return flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES


def solve_bound(N: int, k: int):
    """(seconds at the f32 rate, seconds at the memory rate) of the work
    one chol_solve launch needs: the lower triangle of A and b read once,
    x written once; k³/3 FLOP of Cholesky and 2k² of the two triangular
    solves per system."""
    flops = N * (k ** 3 / 3 + 2 * k * k)
    nbytes = 4 * N * (k * (k + 1) // 2 + 2 * k)
    return flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES


def add_bound(row: dict, flop_s: float, byte_s: float) -> float:
    """Adds one launch's bound (the larger of its two times) to ``row``'s
    sums; returns it in ms."""
    key = "ops_bound_s" if flop_s >= byte_s else "bytes_bound_s"
    row[key] += max(flop_s, byte_s)
    return max(flop_s, byte_s) * 1e3


def gram_library(torch, F, idx, wo, wb):
    """One PyTorch formulation of the same function: gather, then bmm of
    the weighted block (row chunks, so the largest bucket fits)."""
    outs = []
    for sl in _row_chunks(idx.shape[0], idx.shape[1] * F.shape[1]):
        G = F[idx[sl].long()]
        A = torch.bmm((G * wo[sl, :, None]).transpose(1, 2), G)
        b = torch.bmm(wb[sl, None, :], G)[:, 0]
        outs.append((A, b))
    return outs


def rel64(A, b, A64, b64) -> float:
    """max|dA| / max|A64| and max|db| / max|b64|, the larger."""
    return max(((A.double() - A64).abs().max() / A64.abs().max()).item(),
               ((b.double() - b64).abs().max() / b64.abs().max()).item())


def time_training_kernels(torch, ops, dev, train) -> dict:
    """Phase 6: gather_gram on every bucket of the ML-20M layout (both
    half-steps of one iteration, the trained factors as F) and chol_solve
    at both sides' N, each beside its plain version, one library call and
    the bound. Each bucket's result is held against a float64 reference
    (max|dA| / max|A64| and max|db| / max|b64| <= 1e-5, A exactly
    symmetric; the plain version's distance is printed beside), and where
    its plan packs rows, the bucket is timed again with one row a block,
    which must give the same bits. Returns the per-iteration sums."""
    import numpy as np

    from predictionio_tpu_torch.ops import _build

    prep, U, V = train["prep"], train["U"], train["V"]
    out = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_bound_s=0.0,
                      bytes_bound_s=0.0) for name in ("gather_gram", "chol_solve")}
    g = out["gather_gram"]
    tile = _build.load("gather_gram").pio_gather_gram_tile_slots(RANK)
    slot_sums = dict(padded=0, rated=0, multiplied=0)
    worst = worst_plain = packed_ms = one_row_ms = 0.0
    for name, side, F_np in (("user", prep.u_side, V), ("item", prep.i_side, U)):
        # the factors in the other side's permuted order, as training holds them
        other = prep.i_side if side is prep.u_side else prep.u_side
        F = torch.as_tensor(F_np[other.perm]).to(dev)
        for b in side.buckets:
            R = b.n_slabs * b.slab
            label = (f"{name} {'seg ' if b.seg is not None else ''}bucket "
                     f"R={R} C={b.C}")
            idx = torch.as_tensor(b.other_idx.reshape(R, b.C)).to(dev)
            wo = torch.as_tensor(b.mask.reshape(R, b.C)).to(dev)
            wb = torch.as_tensor((b.vals * b.mask).reshape(R, b.C)).to(dev)
            A, bv = ops.gather_gram(F, idx, wo, wb)
            Ar, br = gram_plain(torch, ops, F, idx, wo, wb)
            A64, b64 = gram64(torch, F, idx, wo, wb)
            rel, rel_plain = rel64(A, bv, A64, b64), rel64(Ar, br, A64, b64)
            sym = torch.equal(A, A.transpose(1, 2))
            check(bool(torch.isfinite(A).all()) and rel <= GRAM_TOL and sym,
                  f"gather_gram on {label}: off float64 {rel:.3e}, symmetric {sym}")
            worst, worst_plain = max(worst, rel), max(worst_plain, rel_plain)
            del Ar, br, A64, b64
            iters = 20 if R * b.C < (1 << 22) else 5
            kern, _ = cuda_ms(lambda: ops.gather_gram(F, idx, wo, wb), iters=iters,
                              warmup=2)
            plan = ops.gram.gram_plan(R, b.C)
            one_row = ""
            if plan.rows_per_block > 1:
                one = ops.gram.GramPlan(1, b.C, 1)
                with mock.patch.object(ops.gram, "gram_plan", lambda *_: one):
                    A1, b1 = ops.gather_gram(F, idx, wo, wb)
                    one_ms, _ = cuda_ms(lambda: ops.gather_gram(F, idx, wo, wb),
                                        iters=iters, warmup=2)
                check(torch.equal(A1, A) and torch.equal(b1, bv),
                      f"gather_gram on {label}: one row a block changed the result")
                packed_ms += kern
                one_row_ms += one_ms
                one_row = f" one-row-a-block={one_ms:.4f}"
                del A1, b1
            del A, bv
            plain, _ = cuda_ms(lambda: gram_plain(torch, ops, F, idx, wo, wb),
                               iters=3, warmup=1)
            lib, _ = cuda_ms(lambda: gram_library(torch, F, idx, wo, wb),
                             iters=3, warmup=1)
            live = (wo != 0) | (wb != 0)
            slots = int(np.count_nonzero(b.mask))
            f_rows = int(torch.unique(idx[live]).numel())
            done = multiplied_slots(torch, wo, wb, tile)
            fs, bs = gram_bound(R, b.C, RANK, slots, f_rows)
            g["ms"] += kern
            g["plain_ms"] += plain
            g["library_ms"] += lib
            for key, n in (("padded", R * b.C), ("rated", slots), ("multiplied", done)):
                slot_sums[key] += n
            bound = add_bound(g, fs, bs)
            print(f"gather_gram time {label} k={RANK} ({R * b.C} padded slots, "
                  f"{slots} rated, {done} multiplied (modelled), {f_rows} rows "
                  f"of F; split={plan.split} rows/block={plan.rows_per_block}) "
                  f"off float64 {rel:.3e} (plain {rel_plain:.3e}) device "
                  f"ms: kernel={kern:.4f}{one_row} plain={plain:.4f} "
                  f"library(F[idx]+bmm)={lib:.4f} bound={bound:.4f} "
                  f"({'operations' if fs >= bs else 'bytes'}; f32 FMA "
                  f"{fs * 1e3:.4f}, bytes {bs * 1e3:.4f}); "
                  f"{slots * (RANK * RANK + 5 * RANK) / kern / 1e9:.2f} "
                  f"needed TFLOP/s", flush=True)
            del idx, wo, wb, live
    print(f"gather_gram slots over both half-steps: {slot_sums['padded']} padded, "
          f"{slot_sums['rated']} rated, {slot_sums['multiplied']} multiplied "
          f"(modelled); off float64 by at most {worst:.3e}, the plain version "
          f"by at most {worst_plain:.3e}; the packed buckets {packed_ms:.3f} ms, "
          f"{one_row_ms:.3f} ms with one row a block", flush=True)
    c = out["chol_solve"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for N in (N_USERS, N_ITEMS):
        A, b = spd_systems(torch, gen, dev, N, RANK)
        kern, _ = cuda_ms(lambda: ops.chol_solve(A, b), iters=10, warmup=2)
        plain, _ = cuda_ms(lambda: ops.chol_solve_ref(A, b), iters=5, warmup=1)
        lib, _ = cuda_ms(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(A)), iters=5, warmup=1)
        fs, bs = solve_bound(N, RANK)
        c["ms"] += kern
        c["plain_ms"] += plain
        c["library_ms"] += lib
        bound = add_bound(c, fs, bs)
        print(f"chol_solve time N={N} k={RANK} device ms: kernel={kern:.4f} "
              f"plain={plain:.4f} library(cholesky+cholesky_solve)={lib:.4f} "
              f"bound={bound:.4f} ({'operations' if fs >= bs else 'bytes'}; "
              f"f32 FMA {fs * 1e3:.4f}, bytes {bs * 1e3:.4f})", flush=True)
        del A, b
    for name, row in out.items():
        row["bound_ms"] = (row["ops_bound_s"] + row["bytes_bound_s"]) * 1e3
        row["bound_by"] = ("operations" if row["ops_bound_s"] >= row["bytes_bound_s"]
                           else "bytes")
        print(f"per ALS iteration (both half-steps): {name} kernel "
              f"{row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['ops_bound_s'] * 1e3:.3f} ms in launches bound by "
              f"operations, {row['bytes_bound_s'] * 1e3:.3f} ms by bytes), "
              f"{row['ms'] / row['bound_ms']:.1f}x the bound", flush=True)
    return out


def rows_gram_bound(R: int, W: int, k: int, slots: int, f_bytes: int = 4):
    """(seconds at the f32 rate, seconds at the memory rate) of the work
    one rows_gram launch needs: per slot of nonzero weight (``slots``)
    k(k+1)/2 + 2k FMAs and its row of F_g read once (a row at zero weight
    adds nothing); both weights of every slot read once, A and b written
    once."""
    flops = slots * (k * k + 5 * k)
    nbytes = slots * k * f_bytes + 8 * R * W + 4 * R * (k * k + k)
    return flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES


def rows_gram_library(torch, F_g, wo, wb):
    """One PyTorch formulation of the same function: bmm of the weighted
    block."""
    A = torch.bmm((F_g * wo[..., None]).transpose(1, 2), F_g)
    b = torch.bmm(wb[:, None, :], F_g)[:, 0]
    return A, b


def rows_gram_chunks(torch, dev, prep, U, V):
    """The ML-20M layout's buckets (both half-steps, the trained factors
    as F) as pre-gathered blocks: yields (label, F_g, wo, wb, rated
    slots), F_g = F[idx] gathered in row chunks of at most 2^26 values."""
    import numpy as np

    for name, side, F_np in (("user", prep.u_side, V), ("item", prep.i_side, U)):
        other = prep.i_side if side is prep.u_side else prep.u_side
        F = torch.as_tensor(F_np[other.perm]).to(dev)
        for b in side.buckets:
            R = b.n_slabs * b.slab
            idx = torch.as_tensor(b.other_idx.reshape(R, b.C)).to(dev)
            mask = b.mask.reshape(R, b.C)
            wo = torch.as_tensor(mask).to(dev)
            wb = torch.as_tensor((b.vals * b.mask).reshape(R, b.C)).to(dev)
            for sl in _row_chunks(R, b.C * RANK):
                label = (f"{name} {'seg ' if b.seg is not None else ''}bucket "
                         f"C={b.C} rows {sl.start}:{sl.stop}")
                yield (label, F[idx[sl].long()], wo[sl].contiguous(),
                       wb[sl].contiguous(), int(np.count_nonzero(mask[sl])))


def time_rows_gram(torch, ops, dev, train) -> dict:
    """Phase 6: rows_gram's path is its op entry point (no training or
    serving path calls it). It is driven once over every bucket of the
    ML-20M layout, pre-gathered as F[idx] outside the kernel, with the
    launch counters zeroed just before and read just after, each result
    held against a float64 reference on the same inputs (max|dA| /
    max|A64| and max|db| / max|b64| <= 1e-5; the plain version, an f32
    product in another order, is compared with the same reference and
    printed beside it); then each chunk is timed beside the
    plain version, one library call (bmm of the weighted block), the
    bound, and gather_gram on the same rows (F_g as its factor table, the
    identity as its index), which multiplies every padded slot."""
    prep, U, V = train["prep"], train["U"], train["V"]
    reset_counters(ops)
    worst = worst_plain = max_abs = 0.0
    for label, F_g, wo, wb, _ in rows_gram_chunks(torch, dev, prep, U, V):
        A, b = ops.rows_gram(F_g, wo, wb)
        Ar, br = ops.rows_gram_ref(F_g, wo, wb)
        F64 = F_g.double()
        A64 = torch.einsum("rw,rwk,rwl->rkl", wo.double(), F64, F64)
        b64 = torch.einsum("rw,rwk->rk", wb.double(), F64)
        del F64
        rel, rel_plain = rel64(A, b, A64, b64), rel64(Ar, br, A64, b64)
        print(f"rows_gram path {label}: off float64 {rel:.3e}, plain version "
              f"off float64 {rel_plain:.3e}", flush=True)
        check(bool(torch.isfinite(A).all()) and rel <= GRAM_TOL,
              f"rows_gram off float64 on {label}: {rel:.3e}")
        worst, worst_plain = max(worst, rel), max(worst_plain, rel_plain)
        max_abs = max(max_abs, (A - Ar).abs().max().item(), (b - br).abs().max().item())
        del F_g, wo, wb, A, b, Ar, br, A64, b64
    launches = read_counters(ops)["rows_gram"]
    print(f"rows_gram path: {launches} launches over the ML-20M layout's "
          f"buckets; off float64 by at most {worst:.3e} (relative to max|A64|, "
          f"max|b64|), the plain version by at most {worst_plain:.3e}; kernel "
          f"against plain at most {max_abs:.3e} absolute", flush=True)
    check(launches > 0, "rows_gram was not launched on its path")

    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_bound_s=0.0,
               bytes_bound_s=0.0, launches=launches)
    gather_ms = 0.0
    for label, F_g, wo, wb, slots in rows_gram_chunks(torch, dev, prep, U, V):
        R, W, _ = F_g.shape
        idx = torch.arange(R * W, device=dev, dtype=torch.int32).reshape(R, W)
        F_flat = F_g.view(R * W, RANK)
        iters = 20 if R * W < (1 << 22) else 5
        kern, _ = cuda_ms(lambda: ops.rows_gram(F_g, wo, wb), iters=iters, warmup=2)
        gath, _ = cuda_ms(lambda: ops.gather_gram(F_flat, idx, wo, wb), iters=iters,
                          warmup=2)
        plain, _ = cuda_ms(lambda: ops.rows_gram_ref(F_g, wo, wb), iters=3, warmup=1)
        lib, _ = cuda_ms(lambda: rows_gram_library(torch, F_g, wo, wb), iters=3,
                         warmup=1)
        fs, bs = rows_gram_bound(R, W, RANK, slots)
        row["ms"] += kern
        row["plain_ms"] += plain
        row["library_ms"] += lib
        gather_ms += gath
        bound = add_bound(row, fs, bs)
        print(f"rows_gram time {label} R={R} W={W} k={RANK} ({slots} rated "
              f"slots) device ms: kernel={kern:.4f} gather_gram(identity)="
              f"{gath:.4f} plain={plain:.4f} library(bmm)={lib:.4f} "
              f"bound={bound:.4f} ({'operations' if fs >= bs else 'bytes'}; "
              f"f32 FMA {fs * 1e3:.4f}, bytes {bs * 1e3:.4f})", flush=True)
        del F_g, F_flat, idx, wo, wb
    row["bound_ms"] = (row["ops_bound_s"] + row["bytes_bound_s"]) * 1e3
    row["bound_by"] = ("operations" if row["ops_bound_s"] >= row["bytes_bound_s"]
                       else "bytes")
    print(f"rows_gram over the whole layout (both half-steps): kernel "
          f"{row['ms']:.3f} ms, gather_gram on the same rows {gather_ms:.3f} ms, "
          f"plain {row['plain_ms']:.3f} ms, library "
          f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
          f"({row['ops_bound_s'] * 1e3:.3f} ms in launches bound by operations, "
          f"{row['bytes_bound_s'] * 1e3:.3f} ms by bytes), "
          f"{row['ms'] / row['bound_ms']:.1f}x the bound", flush=True)
    return row


def pio_train_through_cli(torch, ops, dev) -> None:
    """Phase 7: `train` through the port's CLI on the card, then deploy the
    instance it wrote and check 20 answers against the plain reference."""
    import numpy as np

    from predictionio_tpu_torch.core.workflow import (RECOMMENDATION_FACTORY,
                                                      prepare_deploy)
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.storage import Storage, StorageConfig

    repo = os.path.dirname(os.path.abspath(__file__))
    engine_dir = os.path.join(repo, "predictionio_tpu_torch", "templates",
                              "recommendation")
    with open(os.path.join(engine_dir, "engine.json")) as f:
        app_name = json.load(f)["datasource"]["params"]["appName"]
    with tempfile.TemporaryDirectory(prefix="pio_chip_train_") as home:
        storage = Storage(StorageConfig(home=home))
        app = storage.meta.create_app(app_name)
        users, items, ratings = synthetic_ml20m(APP_EVENTS, APP_USERS, APP_ITEMS,
                                                seed=SEED + 3)
        t0 = time.perf_counter()
        for s in range(0, APP_EVENTS, 20_000):
            storage.events.insert_batch([
                Event(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties={"rating": float(r)})
                for u, i, r in zip(users[s:s + 20_000], items[s:s + 20_000],
                                   ratings[s:s + 20_000])], app.id)
        print(f"{APP_EVENTS} rate events ({len(np.unique(users))} users x "
              f"{len(np.unique(items))} items) written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "train",
             "--engine-dir", engine_dir],
            cwd=repo, env=dict(os.environ, PIO_HOME=home), capture_output=True,
            text=True, timeout=600)
        print(proc.stdout.strip(), flush=True)
        check(proc.returncode == 0, f"pio train failed ({proc.returncode}):\n"
                                    f"{proc.stderr[-4000:]}")
        found = dict(re.findall(r"(\w+)=(\d+)", proc.stdout.split(
            "kernel launches:")[-1]))
        print(f"pio train subprocess {time.perf_counter() - t0:.1f} s wall; "
              f"kernel launches {found}", flush=True)
        for name in ("gather_gram", "chol_solve"):
            check(int(found.get(name, 0)) > 0,
                  f"pio train did not launch {name}")

        # the catalog is under the host-scoring threshold: ask for the card
        prev = os.environ.get("PIO_ALS_SERVE")
        os.environ["PIO_ALS_SERVE"] = "device"
        try:
            eng = prepare_deploy(RECOMMENDATION_FACTORY,
                                 storage=Storage(StorageConfig(home=home)),
                                 device=dev)
            check(eng.instance.status == "COMPLETED", "instance not COMPLETED")
            model = eng.models[0]
            rng = np.random.default_rng(SEED + 4)
            inv = model.user_ids.inverse()
            rows = rng.choice(len(model.user_ids), 20, replace=False)
            reset_counters(ops)
            answers = [eng.query({"user": inv[int(r)], "num": 10}) for r in rows]
            served = read_counters(ops)["score_topk"]
        finally:
            if prev is None:
                os.environ.pop("PIO_ALS_SERVE")
            else:
                os.environ["PIO_ALS_SERVE"] = prev
        check(served > 0, "the deployed instance was not served by score_topk")
        Ud = torch.as_tensor(model.U, device=dev)
        Vd = torch.as_tensor(model.V, device=dev)
        ids = torch.as_tensor(rows.astype(np.int32), device=dev)
        rv, ri = ops.score_topk_ref(Ud, Vd, 10, ids=ids)
        s64 = Ud[ids.long()].double() @ Vd.double().T
        item_ids = model.item_ids
        bad = 0
        for j, a in enumerate(answers):
            got_idx = torch.tensor([item_ids[it["item"]] for it in a["itemScores"]],
                                   device=dev)
            got_val = torch.tensor([it["score"] for it in a["itemScores"]], device=dev)
            if len(got_idx) != 10 or not topk_agrees(
                    got_val[None], got_idx[None], rv[j:j + 1], ri[j:j + 1],
                    s64[j:j + 1]):
                bad += 1
        print(f"deployed instance {eng.instance.id} ({model.U.shape[0]} users x "
              f"{model.V.shape[0]} items, rank {model.U.shape[1]}): 20 answers, "
              f"{bad} off the reference; score_topk launches {served}", flush=True)
        check(bad == 0, f"{bad} of 20 answers disagree with score_topk_ref")


def write_instance(home: str, U, V):
    """Phase 8 set-up: one COMPLETED instance at ML-20M width holding the
    factors phase 5 trained, written through the port's storage and
    save_model."""
    from predictionio_tpu_torch.controller import params_to_json
    from predictionio_tpu_torch.core.workflow import RECOMMENDATION_FACTORY
    from predictionio_tpu_torch.storage import (EngineInstance, Storage,
                                                StorageConfig)
    from predictionio_tpu_torch.storage.meta import utcnow
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm, ALSAlgorithmParams, ALSModel, DataSourceParams)
    from predictionio_tpu_torch.utils.bimap import BiMap

    model = ALSModel(U, V, BiMap.string_int(f"u{i}" for i in range(N_USERS)),
                     BiMap.string_int(f"i{j}" for j in range(N_ITEMS)))
    storage = Storage(StorageConfig(home=home))
    iid = storage.meta.new_instance_id()
    factory = RECOMMENDATION_FACTORY
    storage.models.put(iid, pickle.dumps(
        [ALSAlgorithm(ALSAlgorithmParams(rank=RANK)).save_model(model, None)]))
    now = utcnow()
    storage.meta.insert_engine_instance(EngineInstance(
        id=iid, status="COMPLETED", start_time=now, end_time=now,
        engine_factory=factory, engine_variant="default", batch="chip_smoke",
        env={}, mesh_conf={},
        data_source_params=json.dumps(params_to_json(DataSourceParams(app_name="ML20M"))),
        preparator_params="{}",
        algorithms_params=json.dumps([{"name": "als", "params": params_to_json(
            ALSAlgorithmParams(rank=RANK, seed=SEED))}]),
        serving_params="{}"))
    return storage, factory, U, V


def drive_server(torch, ops, dev, home: str, U, V):
    """Phase 8: deploy through the port's EngineServer and query it."""
    import numpy as np

    from predictionio_tpu_torch.server.engine_server import EngineServer

    t0 = time.perf_counter()
    storage, factory, U, V = write_instance(home, U, V)
    print(f"instance written: {N_USERS} x {N_ITEMS} rank {RANK} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    server = EngineServer(engine_factory=factory, storage=storage,
                          host="127.0.0.1", port=0, batching=True,
                          batch_max=BATCH_MAX, aot_buckets="auto",
                          aot_topk=AOT_TOPK, device=dev)
    check(server._warmup.wait(600) and server._warmup.ready,
          f"AOT warmup did not finish: {server._warmup.progress()}")
    print(f"deployed and warmed in {time.perf_counter() - t0:.1f} s: "
          f"{server._warmup.progress()}", flush=True)

    loop = asyncio.new_event_loop()
    serve = threading.Thread(target=loop.run_until_complete,
                             args=(server.serve_forever(),), daemon=True)
    serve.start()
    deadline = time.time() + 60
    while server.http._server is None:
        check(time.time() < deadline and serve.is_alive(), "server did not start")
        time.sleep(0.05)
    url = f"http://127.0.0.1:{server.http.bound_port}"

    def post(q):
        t = time.perf_counter()
        req = urllib.request.Request(f"{url}/queries.json",
                                     data=json.dumps(q).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        return body, time.perf_counter() - t

    rng = np.random.default_rng(SEED + 2)
    seq = [{"user": f"u{int(u)}", "num": int(n)} for u, n in zip(
        rng.integers(0, N_USERS, 200), rng.choice([5, 10, 16], 200))]
    burst = [{"user": f"u{int(u)}", "num": 10}
             for u in rng.integers(0, N_USERS, 512)]

    reset_counters(ops)
    batches0 = server._batcher.batches
    seq_out = [post(q) for q in seq]
    with ThreadPoolExecutor(64) as pool:
        t_burst = time.perf_counter()
        burst_out = list(pool.map(post, burst))
        t_burst = time.perf_counter() - t_burst
    launches = read_counters(ops)
    batches = server._batcher.batches - batches0

    urllib.request.urlopen(f"{url}/stop", timeout=10).read()
    serve.join(30)
    check(not serve.is_alive(), "server did not stop")
    loop.close()

    # every answer against the plain reference on the card
    queries = seq + burst
    answers = [b for b, _ in seq_out + burst_out]
    rows = torch.tensor([int(q["user"][1:]) for q in queries], device=dev,
                        dtype=torch.int32)
    Ud = torch.as_tensor(U, device=dev)
    Vp = torch.cat([torch.as_tensor(V, device=dev),
                    torch.zeros(N_PAD - N_ITEMS, RANK, device=dev)])
    rv, ri = ops.score_topk_ref(Ud, Vp, AOT_TOPK, n_valid=N_ITEMS, ids=rows)
    s64 = Ud[rows.long()].double() @ Vp.double().T
    bad = 0
    for j, (q, a) in enumerate(zip(queries, answers)):
        n = q["num"]
        items = a.get("itemScores", [])
        if len(items) != n:
            bad += 1
            continue
        got_idx = torch.tensor([int(it["item"][1:]) for it in items], device=dev)
        got_val = torch.tensor([it["score"] for it in items], device=dev)
        if not topk_agrees(got_val[None], got_idx[None], rv[j:j + 1, :n],
                           ri[j:j + 1, :n], s64[j:j + 1]):
            bad += 1
    lat = np.asarray([t for _, t in seq_out]) * 1e3
    blat = np.asarray([t for _, t in burst_out]) * 1e3
    print(f"queries: {len(seq)} sequential p50={np.percentile(lat, 50):.3f} ms "
          f"p99={np.percentile(lat, 99):.3f} ms; burst of {len(burst)} over 64 "
          f"clients p50={np.percentile(blat, 50):.3f} ms "
          f"p99={np.percentile(blat, 99):.3f} ms "
          f"({len(burst) / t_burst:.1f} q/s); {batches} device batches; "
          f"kernel launches {launches}; answers off the reference: {bad}",
          flush=True)
    check(bad == 0, f"{bad} of {len(queries)} answers disagree with score_topk_ref")
    check(launches["score_topk"] > 0, "score_topk was not launched on the serving path")
    return launches


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from predictionio_tpu_torch import ops
    from predictionio_tpu_torch.ops import _build

    quick = "--quick" in argv
    dev = torch.device("cuda", 0)

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2. build")
    t0 = time.perf_counter()
    _build.build(ops.KERNELS)
    print(f"{len(ops.KERNELS)} kernels built in parallel in "
          f"{time.perf_counter() - t0:.2f} s ({' '.join(_build.NVCC_FLAGS)})",
          flush=True)
    for name in ops.KERNELS:
        info = _build.BUILD_INFO.get(name)
        if info is None:
            print(f"{name}: library already on disk, not rebuilt", flush=True)
            continue
        print(f"{name} built in {info['seconds']:.2f} s", flush=True)
        print(info["log"].strip(), flush=True)

    phase("3. kernels against their plain versions")
    main_err = check_score_topk(torch, ops, dev)
    gram_err = check_gather_gram(torch, ops, dev)
    solve_err = check_chol_solve(torch, ops, dev)
    rows_err = check_rows_gram(torch, ops, dev)
    if quick:
        return 0

    phase("4. score_topk timing")
    times = time_score_topk(torch, ops, dev)
    if "--profile" in argv:
        profile_score_topk(torch, ops, dev)

    phase("5. full-width training (ML-20M shape, rank 64)")
    train = train_full_width(torch, ops, dev)

    phase("6. gather_gram, chol_solve and rows_gram at the training path's shapes")
    ttimes = time_training_kernels(torch, ops, dev, train)
    rows = time_rows_gram(torch, ops, dev, train)
    if "--profile" in argv:
        profile_training(torch, dev, train)

    phase("7. pio train through the port's CLI, then deploy")
    pio_train_through_cli(torch, ops, dev)

    phase("8. Recommendation engine served at ML-20M width (trained factors)")
    with tempfile.TemporaryDirectory(prefix="pio_chip_smoke_") as home:
        launches = drive_server(torch, ops, dev, home, train["U"], train["V"])
    phase("done")

    main = times[BATCH_MAX]
    gram, solve = ttimes["gather_gram"], ttimes["chol_solve"]
    print(json.dumps({"kernels": [{
        "name": "score_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/score_topk.cu",
        "replaces": "predictionio_tpu/ops/topk.py:278",
        "launches": launches["score_topk"], "max_abs_err": main_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }, {
        "name": "gather_gram", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/gather_gram.cu",
        "replaces": "predictionio_tpu/ops/gram.py:203",
        "launches": train["launches"]["gather_gram"], "max_abs_err": gram_err,
        "ms": gram["ms"], "plain_ms": gram["plain_ms"],
        "bound_ms": gram["bound_ms"], "bound_by": gram["bound_by"],
        "library_ms": gram["library_ms"],
    }, {
        "name": "chol_solve", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/chol_solve.cu",
        "replaces": "predictionio_tpu/ops/cholesky.py:315",
        "launches": train["launches"]["chol_solve"], "max_abs_err": solve_err,
        "ms": solve["ms"], "plain_ms": solve["plain_ms"],
        "bound_ms": solve["bound_ms"], "bound_by": solve["bound_by"],
        "library_ms": solve["library_ms"],
    }, {
        "name": "rows_gram", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/rows_gram.cu",
        "replaces": "predictionio_tpu/ops/gram.py:73",
        "launches": rows["launches"], "max_abs_err": rows_err,
        "ms": rows["ms"], "plain_ms": rows["plain_ms"],
        "bound_ms": rows["bound_ms"], "bound_by": rows["bound_by"],
        "library_ms": rows["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
