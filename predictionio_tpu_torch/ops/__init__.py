"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version.

- :mod:`.topk` — streaming score + top-k over the item factors (serving).
- :mod:`.gram` — fused gather → weighted Gram (ALS training).
- :mod:`.cholesky` — batched SPD solve of the normal equations (ALS
  training).
- :mod:`.rows_gram` — weighted Gram over a pre-gathered block (the op
  entry point of the JAX package's ``rows_gram``).

:mod:`.segment` (segment sums, counts and means for the e2 helpers) is
plain PyTorch, as its JAX counterpart is plain XLA: no kernel, no counter.

Which path runs is decided by the device of the tensors alone: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. There is no switch.
"""

from predictionio_tpu_torch.ops.cholesky import chol_solve, chol_solve_ref
from predictionio_tpu_torch.ops.gram import gather_gram, gather_gram_ref
from predictionio_tpu_torch.ops.rows_gram import rows_gram, rows_gram_ref
from predictionio_tpu_torch.ops.topk import MAX_K, score_topk, score_topk_ref

#: every kernel wrapper; each counts its launches in ``.launches``
LAUNCH_COUNTERS = (score_topk, gather_gram, chol_solve, rows_gram)

#: the source (``csrc/<name>.cu``) of every kernel
KERNELS = ("score_topk", "gather_gram", "chol_solve", "rows_gram")

__all__ = ["KERNELS", "LAUNCH_COUNTERS", "MAX_K", "chol_solve", "chol_solve_ref",
           "gather_gram", "gather_gram_ref", "rows_gram", "rows_gram_ref",
           "score_topk", "score_topk_ref"]
