"""The yardstick's work functions against hand counts at small shapes."""

from __future__ import annotations

import pytest

from benchlib import work


def test_als_model_flops_hand_count():
    # k = 2: per rating k(k+1) + 2k = 10 FLOP; per entity 8/3 + 8 FLOP
    got = work.als_model_flops(nnz=3, rated_users=2, rated_items=1, k=2, iterations=1)
    assert got == pytest.approx(2 * 3 * 10 + 3 * (8 / 3 + 8))


def test_gram_call_bound_hand_count():
    flops, nbytes = work.gram_call_bound(valid_slots=5, rows=2, f_rows=3, k=4)
    assert flops == 5 * (16 + 20)
    assert nbytes == 12 * 5 + 4 * 3 * 4 + 4 * 2 * (16 + 4)


def test_solve_call_bound_hand_count():
    flops, nbytes = work.solve_call_bound(n_systems=2, k=3)
    assert flops == pytest.approx(2 * (9 + 18))
    assert nbytes == 4 * 2 * (6 + 6)


def test_ann_dispatch_bound_hand_count():
    flops, nbytes = work.ann_dispatch_bound(B=2, n_items=10, m=2, K=4, d=4, kprime=3, k=2)
    assert flops == 2 * 2 * 4 * 4 + 2 * 10 * 2 + 2 * 2 * 3 * 4
    assert nbytes == 10 * 2 + 4 * 2 * 4 * 2 + 4 * 2 * 4 + 4 * 2 * 3 * 4 + 8 * 2 * 2


def test_bound_is_the_larger_time():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.dispatch_work({4: 3}, 100, 2, 4, 4, 3, 2) == pytest.approx(
        3 * work.bound_s(*work.ann_dispatch_bound(4, 100, 2, 4, 4, 3, 2)))
