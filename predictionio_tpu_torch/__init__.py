"""predictionio_tpu_torch: the PyTorch and CUDA port of predictionio_tpu.

The module paths mirror the JAX package's, so each counterpart is found
at the same place. The port imports torch, numpy and the standard
library only; it never imports jax or predictionio_tpu, and keeps its own
copy of what it needs from the layers that never touched jax. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
with no card and no such request they raise.
"""

from predictionio_tpu_torch.version import __version__

__all__ = ["__version__"]
