"""Attention for the sequence models: the single-device part of the JAX
package's ``parallel`` package (the mesh, the distributed runtime and the
sequence-parallel paths wait for ROADMAP.md queue 1, item 8)."""

from predictionio_tpu_torch.parallel.ring_attention import (
    attention_reference,
    ring_attention,
)

__all__ = ["attention_reference", "ring_attention"]
