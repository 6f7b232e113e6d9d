"""The device mesh, the multi-process runtime (``distributed``) and the
sequence models' attention: the JAX package's ``parallel`` package less
the sequence-parallel paths (Ulysses and the multi-device ring wait for
ROADMAP.md queue 1, item 8b)."""

from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from predictionio_tpu_torch.parallel.ring_attention import (
    attention_reference,
    ring_attention,
)

__all__ = ["MeshConfig", "make_mesh", "attention_reference", "ring_attention"]
