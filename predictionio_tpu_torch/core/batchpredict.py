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
    ``shards > 1`` (the JAX package's item-sharded ANN retrieval mesh) is
    not ported and raises; 0 and 1 run on the one device."""
    if shards and int(shards) > 1:
        raise ValueError(
            f"--shards {shards}: sharded retrieval is not ported to "
            "predictionio_tpu_torch yet (ROADMAP.md queue 1, items 9 and 14); "
            "use --shards 0")
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
