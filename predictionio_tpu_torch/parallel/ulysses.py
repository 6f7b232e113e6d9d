"""Ulysses-style sequence parallelism: resharding sequence ↔ heads.

The port of the JAX package's ``parallel/ulysses.py`` (the
DeepSpeed-Ulysses pattern, public): activations arrive split on the
**sequence** over the slots of one mesh axis; an all-to-all reshards
them onto the **heads** with the whole sequence on each slot, standard
attention (:func:`~predictionio_tpu_torch.parallel.ring_attention.attention_reference`)
runs per head group, and a second all-to-all restores the sequence
split. The key mask is all-gathered. Each all-to-all is per-slot slicing
and copies: slot i takes head group i of every slot's sequence block,
and back. The slots' outputs are gathered onto the queries' device.

Ring attention (``.ring_attention``) scales sequence length with the
slot count at O(block²) memory; Ulysses keeps full-sequence attention
local (better for short-ish sequences with many heads). Both are exact.
Plain autograd throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

from predictionio_tpu_torch.parallel.mesh import process_slots
from predictionio_tpu_torch.parallel.ring_attention import attention_reference


def _ulysses(q, k, v, k_mask, slots, causal: bool) -> torch.Tensor:
    n = len(slots)
    S, H = q.shape[1], q.shape[2]
    sb, hb = S // n, H // n
    home = q.device

    def seq_shares(x):
        """[B, S, ...] → each slot's sequence block [B, S/n, ...]."""
        b = x.shape[1] // n
        return [x[:, j * b:(j + 1) * b].to(dev) for j, dev in enumerate(slots)]

    def seq_to_heads(shares):
        """all_to_all: slot i gets head group i of every sequence block,
        concatenated along the sequence → [B, S, H/n, D]."""
        return [torch.cat([sh[:, :, i * hb:(i + 1) * hb].to(dev) for sh in shares], dim=1)
                for i, dev in enumerate(slots)]

    qh, kh, vh = (seq_to_heads(seq_shares(x)) for x in (q, k, v))
    mask_shares = seq_shares(k_mask)
    outs = []
    for i, dev in enumerate(slots):
        mask = torch.cat([m.to(dev) for m in mask_shares], dim=1)   # all_gather
        outs.append(attention_reference(qh[i], kh[i], vh[i], causal=causal,
                                        k_mask=mask))
    # all_to_all back: slot j gets its sequence block of every head group
    back = [torch.cat([o[:, j * sb:(j + 1) * sb].to(dev) for o in outs], dim=2)
            for j, dev in enumerate(slots)]
    return torch.cat([b.to(home) for b in back], dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh=None, axis: str = "data", causal: bool = False,
                      k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention via head-resharding.

    q, k, v: [B, S, H, D]; S and H must both divide by the mesh axis
    size; ``k_mask``: optional [B, Sk] bool key-padding mask. ``mesh`` is
    a ``parallel/mesh.Mesh`` whose slots on ``axis`` all belong to this
    process; ``mesh=None`` (or a 1-slot axis) falls back to the oracle.
    The result is on q's device.
    """
    if mesh is None:
        return attention_reference(q, k, v, causal=causal, k_mask=k_mask)
    if axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has no axis {axis!r} (axes: {mesh.axis_names}); "
            "pass mesh=None for single-device attention")
    if mesh.shape[axis] == 1:
        return attention_reference(q, k, v, causal=causal, k_mask=k_mask)
    n_dev = mesh.shape[axis]
    if q.shape[1] % n_dev or q.shape[2] % n_dev:
        raise ValueError(
            f"seq {q.shape[1]} and heads {q.shape[2]} must divide by mesh "
            f"axis {axis!r} size {n_dev}")
    slots = process_slots(mesh, "Ulysses attention", axis)
    if k_mask is None:
        k_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    return _ulysses(q, k, v, k_mask, slots, causal)
