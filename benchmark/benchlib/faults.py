"""Faults planted in the program underneath a run, to show that the
checks refuse a run whose timed path is broken: each is a context
manager that patches the port for its duration. Used by the CPU tests
(``tests/test_bench_faults.py``) and by ``control.py --fault`` on the
card, never by the benchmark's own runs.

- ``unchanged``: a step returns its state unchanged (ALS: the item
  half-step keeps V; ANN: a dispatch returns its first answer again);
- ``half``: half of the batch left out (ALS: the second half of every
  bucket row's ratings; ANN: the second half of each batch's users get
  the first half's answers);
- ``altered``: an answer altered where it is produced (ALS: one item's
  factor row scaled by 1.01; ANN: the first item of every answer moved
  to the next row of the catalog);
- ``codebooks`` (ANN): the index's Lloyd cut to half its iterations, a
  shortened build that would also shorten ``setup_s``.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np


@contextlib.contextmanager
def als_unchanged():
    from predictionio_tpu_torch.models import als

    real = als._train_permuted

    def stale_items(prep, p, bufs, V0p):
        U, _ = real(prep, p, bufs, V0p)
        return U, V0p

    with mock.patch.object(als, "_train_permuted", stale_items):
        yield


@contextlib.contextmanager
def als_half():
    import torch

    from predictionio_tpu_torch import ops

    real = ops.gather_gram

    def half_rows(F, idx, wo, wb):
        m = (torch.arange(idx.shape[1], device=wo.device) < idx.shape[1] // 2).to(wo.dtype)
        return real(F, idx, wo * m, wb * m)

    with mock.patch.object(ops, "gather_gram", half_rows):
        yield


@contextlib.contextmanager
def als_altered():
    from predictionio_tpu_torch.models import als

    real = als.als_train_prepared

    def altered(*a, **kw):
        U, V = real(*a, **kw)
        V = V.copy()
        V[int(np.argmax(np.abs(V).sum(1)))] *= 1.01
        return U, V

    with mock.patch.object(als, "als_train_prepared", altered):
        yield


@contextlib.contextmanager
def ann_unchanged():
    from predictionio_tpu_torch.ann import scorer

    real = scorer._ANNProgram.__call__
    first = {}

    def stale(self, sc, user_ids, rows_valid):
        if "out" not in first:
            first["out"] = real(self, sc, user_ids, rows_valid)
        return first["out"]

    with mock.patch.object(scorer._ANNProgram, "__call__", stale):
        yield


@contextlib.contextmanager
def ann_half():
    from predictionio_tpu_torch.models import als

    real = als.LadderScorer.recommend_batch

    def half(self, user_ids, num, exclude=None):
        user_ids = np.asarray(user_ids)
        h = max(1, len(user_ids) // 2)
        out = real(self, user_ids[:h], num)
        return (out * (len(user_ids) // h + 1))[:len(user_ids)]

    with mock.patch.object(als.LadderScorer, "recommend_batch", half):
        yield


@contextlib.contextmanager
def ann_altered():
    from predictionio_tpu_torch.ops import topk

    real = topk.rerank_topk

    def altered(Q, V, sidx, k):
        vals, idx = real(Q, V, sidx, k)
        idx = idx.clone()
        idx[:, 0] = (idx[:, 0] + 1) % V.shape[0]
        return vals, idx

    with mock.patch.object(topk, "rerank_topk", altered):
        yield


@contextlib.contextmanager
def ann_codebooks():
    from predictionio_tpu_torch.ann import pq

    real = pq.train_codebooks

    def short(V, m, k, *, iters=8, **kw):
        return real(V, m, k, iters=iters // 2, **kw)

    with mock.patch.object(pq, "train_codebooks", short):
        yield


#: the faults each driver's cells can have, by name
FAULTS = {
    "als_train_loop": {"unchanged": als_unchanged, "half": als_half, "altered": als_altered},
    "batchpredict": {"unchanged": ann_unchanged, "half": ann_half, "altered": ann_altered,
                     "codebooks": ann_codebooks},
}
