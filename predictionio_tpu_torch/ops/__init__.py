"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version.

- :mod:`.topk` — streaming score + top-k over the item factors (serving).

Which path runs is decided by the device of the tensors alone: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. There is no switch.
"""

from predictionio_tpu_torch.ops.topk import MAX_K, score_topk, score_topk_ref

#: every kernel wrapper; each counts its launches in ``.launches``
LAUNCH_COUNTERS = (score_topk,)

__all__ = ["LAUNCH_COUNTERS", "MAX_K", "score_topk", "score_topk_ref"]
