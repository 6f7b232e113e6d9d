"""Approximate nearest-neighbor retrieval: the port of the JAX package's
``ann`` package.

Product-quantized index for two-tower serving at 10M+ item corpora:

- :mod:`.pq` — k-means PQ codebook training (Lloyd on the device) +
  uint8 corpus encoding, run at ``pio train`` time;
- :mod:`.index` — the versioned ``PIOANN01`` index blob (byte-compatible
  with the JAX package's) with sha256 integrity (a corrupt index is
  refused at load and at ``/reload``), sidecars + manifest for ``pio
  index status``;
- :mod:`.scorer` — device-resident serving: ADC lookup-table scan +
  top-k′ shortlist + exact float re-rank, one program per AOT bucket,
  drop-in beside the exact ``ResidentScorer``.

Import cost: :mod:`.index` is numpy only and :mod:`.pq` imports torch
inside its functions, and this root reaches :mod:`.scorer` (and torch,
through ``models/als``) only when one of its names is first asked for,
so ``pio index status`` (the index module and the storage layer alone)
loads no torch.
"""

from predictionio_tpu_torch.ann.index import (INDEX_BASENAME, MANIFEST_BASENAME,
                                              PQIndex, build_index, load_index,
                                              manifest_dict, save_index, shard_view)
from predictionio_tpu_torch.ann.pq import (decode, encode, reconstruction_mse,
                                           train_codebooks, train_opq)

_SCORER_NAMES = ("DEFAULT_SHORTLIST", "ANNScorer", "ShardedANNScorer",
                 "maybe_ann_scorer")


def __getattr__(name):
    if name in _SCORER_NAMES:
        from predictionio_tpu_torch.ann import scorer

        return getattr(scorer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PQIndex", "build_index", "load_index", "save_index", "manifest_dict",
    "shard_view", "INDEX_BASENAME", "MANIFEST_BASENAME",
    "train_codebooks", "train_opq", "encode", "decode",
    "reconstruction_mse",
    "ANNScorer", "ShardedANNScorer", "maybe_ann_scorer",
    "DEFAULT_SHORTLIST",
]
