"""Batch prediction: queries JSONL → predictions JSONL.

The port's ``pio batchpredict`` (reference: [U] core/.../workflow/
BatchPredict.scala; the JAX package's ``core/batchpredict.py``). The
deployed model is resident on the device; queries stream through
``DeployedEngine.batch_query`` in fixed-size batches, so an algorithm
that overrides ``batch_predict`` (the Recommendation template) scores a
whole batch in one device dispatch. Each output line is
``{"query": ..., "prediction": ...}``, as the JAX verb writes it.
"""

from __future__ import annotations

import json
import os
from typing import TextIO

from predictionio_tpu_torch.core.workflow import DeployedEngine

BATCH = 1024


def run_batch_predict(
    deployed: DeployedEngine,
    src: TextIO,
    out: TextIO,
    batch_size: int = BATCH,
    shards: int = 0,
) -> int:
    """Answer every query line of ``src`` into ``out``; returns the count.

    ``shards > 1`` runs the ANN-served templates over the item-sharded
    retrieval mesh (``ann/scorer.ShardedANNScorer``): scorers build
    lazily inside ``batch_predict``, so ``PIO_ANN_SHARDS`` is set for the
    duration of the run, the one hook that reaches every engine variant
    without threading a parameter through the template contract. With
    fewer slots than shards the scorer warns and serves unsharded."""
    if shards and int(shards) > 1:
        prev = os.environ.get("PIO_ANN_SHARDS")
        os.environ["PIO_ANN_SHARDS"] = str(int(shards))
        try:
            return run_batch_predict(deployed, src, out, batch_size)
        finally:
            if prev is None:
                os.environ.pop("PIO_ANN_SHARDS", None)
            else:
                os.environ["PIO_ANN_SHARDS"] = prev
    n = 0
    batch = []

    def flush() -> None:
        nonlocal n
        if not batch:
            return
        for q, p in zip(batch, deployed.batch_query(batch)):
            out.write(json.dumps({"query": q, "prediction": p},
                                 separators=(",", ":")) + "\n")
        n += len(batch)
        batch.clear()

    for line in src:
        line = line.strip()
        if not line:
            continue
        batch.append(json.loads(line))
        if len(batch) >= batch_size:
            flush()
    flush()
    return n
