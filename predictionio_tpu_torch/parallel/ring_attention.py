"""Ring attention: sequence-parallel attention over the slots of a mesh.

The port of the JAX package's ``parallel/ring_attention.py``.
:func:`attention_reference` is written as the JAX package writes it —
the score einsum, then the causal and key masks as ``-inf``, then the row
max, with a fully masked row giving zeros, never NaN.
``scaled_dot_product_attention`` is not used: it returns NaN for a fully
masked row, and every left-padded position of a sequence model is one.

:func:`ring_attention` splits the sequence over the slots of one axis of
a ``parallel/mesh.Mesh``: each slot keeps its query block and the K/V
blocks (with their key-mask blocks) rotate around the ring, a copy to the
next slot a step (the JAX package's ``ppermute``), while an
online-softmax accumulator (o, m, l) folds each block in. K and V blocks
stride by their own length, so Sq ≠ Sk works; causal positions come from
each block's ring origin ``(my − t) mod n``, so the result is that of
one-device causal attention. The last block folds outside the loop,
after the n − 1 rotations. The slots' outputs are gathered back onto the
queries' device in slot order. It is plain autograd throughout, so a
model trains through it (SeqRec).

The rotation/accumulation pattern follows the public blockwise ring
attention formulation (Liu et al., "Ring Attention with Blockwise
Transformers"); the online softmax is the streaming max/denominator fold
of flash-style kernels.

Layout: ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from predictionio_tpu_torch.parallel.mesh import process_slots


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-device softmax attention.

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D] → [B, Sq, H, D].
    ``k_mask``: [B, Sk] bool, False = key position masked out (padding).
    Fully-masked query rows yield zeros, not NaN.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where((ki > qi)[None, None], -torch.inf, s)
    if k_mask is not None:
        s = torch.where(k_mask[:, None, None, :], s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)  # fully-masked rows → zeros
    p = torch.exp(s - m)
    p = torch.where(torch.isneginf(s), 0.0, p)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _fold_block(carry, k, v, k_mask, q, q_pos, k_pos, scale: float,
                causal: bool):
    """Online-softmax fold of one K/V block into (o, m, l).

    o: [B, Sq, H, D] unnormalized output, m: [B, H, Sq] running max,
    l: [B, H, Sq] running denominator; ``k_mask``: [B, Sk_block] bool.
    """
    o, m, l = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = torch.where((k_pos[None, :] > q_pos[:, None])[None, None], -torch.inf, s)
    s = torch.where(k_mask[:, None, None, :], s, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully-masked-so-far rows keep m = -inf; their rescale factor is 0
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_new))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)  # masked entries contribute 0
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    o = o * alpha.transpose(1, 2)[..., None] + pv
    return (o, m_new, l)


def _ring(q, k, v, k_mask, slots, causal: bool) -> torch.Tensor:
    n = len(slots)
    B, S, H, D = q.shape
    sq, sk = S // n, k.shape[1] // n   # K blocks stride by THEIR length
    scale = 1.0 / math.sqrt(D)
    home = q.device
    qs = [q[:, i * sq:(i + 1) * sq].to(dev) for i, dev in enumerate(slots)]
    # the block each slot holds: at step t, the one that ORIGINATED at
    # ring position (my - t) mod n
    held = [(k[:, i * sk:(i + 1) * sk].to(dev), v[:, i * sk:(i + 1) * sk].to(dev),
             k_mask[:, i * sk:(i + 1) * sk].to(dev)) for i, dev in enumerate(slots)]
    carry = []
    for i, dev in enumerate(slots):
        carry.append((torch.zeros(qs[i].shape, dtype=q.dtype, device=dev),
                      torch.full((B, H, sq), -torch.inf, dtype=q.dtype, device=dev),
                      torch.zeros((B, H, sq), dtype=q.dtype, device=dev)))

    def fold_all(t: int) -> None:
        for my, dev in enumerate(slots):
            src = (my - t) % n
            q_pos = my * sq + torch.arange(sq, device=dev)
            k_pos = src * sk + torch.arange(sk, device=dev)
            carry[my] = _fold_block(carry[my], *held[my], qs[my], q_pos, k_pos,
                                    scale, causal)

    # n-1 rotated steps; the last block folds OUTSIDE the loop, so its
    # rotation (whose result would be discarded) never runs
    for t in range(n - 1):
        fold_all(t)
        held = [tuple(x.to(slots[my]) for x in held[(my - 1) % n])
                for my in range(n)]
    fold_all(n - 1)
    outs = []
    for o, _, l in carry:
        l = torch.where(l == 0.0, 1.0, l)  # fully-masked query rows → zeros
        outs.append((o / l.transpose(1, 2)[..., None]).to(home))
    return torch.cat(outs, dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, axis: str = "data", causal: bool = False,
                   k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention; exact (up to fp error) against
    :func:`attention_reference`.

    q, k, v: [B, S, H, D] with S divisible by the mesh axis size;
    ``k_mask``: optional [B, Sk] bool key-padding mask (False = masked).
    ``mesh`` is a ``parallel/mesh.Mesh`` whose slots on ``axis`` all
    belong to this process; ``mesh=None`` (or a 1-slot axis) falls back
    to the local oracle. The result is on q's device.
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
    if q.shape[1] % n_dev or k.shape[1] % n_dev:
        raise ValueError(
            f"seq len {q.shape[1]}/{k.shape[1]} not divisible by mesh "
            f"axis {axis!r} size {n_dev}")
    slots = process_slots(mesh, "ring attention", axis)
    if k_mask is None:
        k_mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    return _ring(q, k, v, k_mask, slots, causal)
