"""The device mesh, the multi-process runtime (``distributed``) and the
sequence models' attention over a mesh: the port of the JAX package's
``parallel`` package (``mesh``, ``distributed``, ``ring_attention``,
``ulysses``)."""

from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from predictionio_tpu_torch.parallel.ring_attention import (
    attention_reference,
    ring_attention,
)
from predictionio_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["MeshConfig", "make_mesh", "attention_reference", "ring_attention",
           "ulysses_attention"]
