"""Softmax attention on one device, and ring attention's entry point.

The port of the single-device part of the JAX package's
``parallel/ring_attention.py``. :func:`attention_reference` is written
as the JAX package writes it — the score einsum, then the causal and
key masks as ``-inf``, then the row max, with a fully masked row giving
zeros, never NaN. ``scaled_dot_product_attention`` is not used: it
returns NaN for a fully masked row, and every left-padded position of a
sequence model is one.

:func:`ring_attention` keeps the JAX signature. With ``mesh=None`` or a
one-device axis it is :func:`attention_reference`; the sequence-parallel
ring over several devices is not ported yet (ROADMAP.md queue 1, item
8b) and raises. A mesh here is a mapping of axis name → size: the
``mesh`` block of an engine.json ``meshConf``, or ``parallel/mesh.Mesh.shape``.

Layout: ``[batch, seq, heads, head_dim]``.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from predictionio_tpu_torch.parallel.mesh import NOT_PORTED


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


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Optional[Mapping[str, int]] = None, axis: str = "data",
                   causal: bool = False,
                   k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention's entry point: ``mesh=None`` or a
    1-device ``axis`` is :func:`attention_reference`; a larger axis
    raises (not ported yet)."""
    if mesh is None:
        return attention_reference(q, k, v, causal=causal, k_mask=k_mask)
    if axis not in mesh:
        raise ValueError(
            f"mesh has no axis {axis!r} (axes: {tuple(mesh)}); "
            "pass mesh=None for single-device attention")
    if int(mesh[axis]) == 1:
        return attention_reference(q, k, v, causal=causal, k_mask=k_mask)
    raise ValueError(f"ring attention over a {mesh[axis]}-device axis "
                     f"{NOT_PORTED}")
