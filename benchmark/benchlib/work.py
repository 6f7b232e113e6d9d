"""The yardstick: the chip's published peaks and the work each measured
piece needs, computed from the problem's shapes, never from the
program's padding.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at its
700 W limit: float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.
The port computes in float32 without TF32 (its rule), so float32 is the
peak every share here is held against.

A bound is the larger of operations over the FLOP rate and bytes over
the memory rate. Inputs are counted as read once and outputs as written
once, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


# -- ALS ---------------------------------------------------------------------


def als_model_flops(nnz: int, rated_users: int, rated_items: int, k: int,
                    iterations: int) -> float:
    """Model FLOPs of one explicit ALS train: each iteration solves both
    sides once. A side's half-step needs, per rating, the symmetric half
    of f fᵀ (k(k+1)/2 multiply-adds, k(k+1) FLOP) and r·f (2k FLOP); per
    entity with ratings, a Cholesky factorisation (k³/3 FLOP) and two
    triangular solves (2k² FLOP). Buckets, padding and the dense head's
    zero cells are not counted."""
    per_rating = k * (k + 1) + 2 * k
    per_entity = k ** 3 / 3 + 2 * k * k
    per_iter = 2 * nnz * per_rating + (rated_users + rated_items) * per_entity
    return iterations * per_iter


def gram_call_bound(valid_slots: int, rows: int, f_rows: int, k: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one gather_gram call: per slot of nonzero weight
    k(k+1)/2 multiply-adds for the lower triangle of A, k for w·f and k
    for b (k² + 5k FLOP, as the port's smoke script counts); the index
    and both weights of each valid slot read once (12 bytes), each
    distinct gathered factor row read once, A and b of each row that has
    a valid slot written once."""
    flops = valid_slots * (k * k + 5 * k)
    nbytes = 12 * valid_slots + 4 * f_rows * k + 4 * rows * (k * k + k)
    return flops, nbytes


def solve_call_bound(n_systems: int, k: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one chol_solve call over its entities with
    ratings: k³/3 FLOP of Cholesky and 2k² of the two triangular solves a
    system; the lower triangle of A and b read once, x written once."""
    flops = n_systems * (k ** 3 / 3 + 2 * k * k)
    nbytes = 4 * n_systems * (k * (k + 1) // 2 + 2 * k)
    return flops, nbytes


def sum_bounds(calls) -> float:
    """Seconds of a list of (FLOP, bytes) calls, each at its own bound."""
    return sum(bound_s(f, b) for f, b in calls)


# -- ANN retrieval ---------------------------------------------------------------


def ann_dispatch_bound(B: int, n_items: int, m: int, K: int, d: int,
                       kprime: int, k: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one ADC-shortlist + exact re-rank dispatch of B
    real queries over n_items codes: the LUT (2·B·K·d), the ADC adds
    (B·n·m), the re-rank (2·B·k′·d); the codes read once (n·m bytes),
    the codebooks, the B queries and the B·k′ gathered rows read once,
    B·k scores and indices written once."""
    flops = 2 * B * K * d + B * n_items * m + 2 * B * kprime * d
    nbytes = n_items * m + 4 * m * K * (d // m) + 4 * B * d + 4 * B * kprime * d + 8 * B * k
    return flops, nbytes


def dispatch_work(calls: Dict[int, int], n_items: int, m: int, K: int, d: int,
                  kprime: int, k: int) -> float:
    """Bound seconds of ``calls`` ({real rows B: number of dispatches})."""
    return sum(n * bound_s(*ann_dispatch_bound(B, n_items, m, K, d, kprime, k))
               for B, n in calls.items())
