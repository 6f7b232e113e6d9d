"""Segment reductions: the per-key sums the e2 helpers group by.

The port of the JAX package's ``ops/segment.py`` (scatter-adds there,
no Pallas kernel): ``index_add_`` into zeros on the tensors' device.
The JAX package's index rules are kept, which ``.at[ids].add`` gives and
``index_add_`` alone does not: a negative id wraps once (``-1`` lands in
the last segment), and an id at or past ``num_segments``, or below
``-num_segments``, is dropped. Dropped rows go to one spare segment
that is sliced off, so no host sync is needed to filter them.
``sorted_ids`` is accepted for the JAX signature and changes nothing.
"""

from __future__ import annotations

import torch


def _segments(segment_ids, num_segments: int, device) -> torch.Tensor:
    """int64 ids with JAX's wrap of negatives; dropped ids → ``num_segments``."""
    ids = torch.as_tensor(segment_ids, device=device).long()
    ids = torch.where(ids < 0, ids + num_segments, ids)
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, torch.full_like(ids, num_segments))


def segment_sum(data, segment_ids, num_segments: int, *,
                sorted_ids: bool = False) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``;
    keeps ``data``'s dtype and device."""
    data = torch.as_tensor(data)
    ids = _segments(segment_ids, num_segments, data.device)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)[:num_segments]


def segment_count(segment_ids, num_segments: int, *,
                  sorted_ids: bool = False) -> torch.Tensor:
    """Occurrence count per segment id, int32."""
    ids = torch.as_tensor(segment_ids)
    ones = torch.ones(ids.shape[:1], dtype=torch.int32, device=ids.device)
    return segment_sum(ones, ids, num_segments)


def segment_mean(data, segment_ids, num_segments: int, *,
                 sorted_ids: bool = False) -> torch.Tensor:
    """Per-segment mean; an empty segment's count floors at 1 (→ 0)."""
    s = segment_sum(data, segment_ids, num_segments)
    c = segment_count(segment_ids, num_segments).clamp_min(1).to(s.dtype)
    return s / c.reshape((-1,) + (1,) * (s.dim() - 1))
