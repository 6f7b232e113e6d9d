"""Versioned sweep leaderboards: the artifact ``pio eval`` persists
next to the evaluation instance row, read by the ``pio evals`` and
``pio eval leaderboard`` inspection verbs.

The port's copy of the JAX package's ``storage/leaderboard.py``: the same
document (``LEADERBOARD_VERSION``, keys, entry order, atomic write under
``<home>/leaderboards/<instance>.json``) and the same ``digest``, so a
leaderboard either package writes is read by the other and equal
rankings share a digest across them. Standard library only: the
inspection verbs import neither torch nor anything that does.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

LEADERBOARD_VERSION = 1


def leaderboard_dir(home: str) -> str:
    return os.path.join(home, "leaderboards")


def leaderboard_path(home: str, instance_id: str) -> str:
    return os.path.join(leaderboard_dir(home), f"{instance_id}.json")


def _key(score: float, higher_is_better: bool) -> float:
    # mirrors controller.evaluation.ranking_key without importing it
    # (that module's closure imports torch); NaN ranks last
    if score is None or math.isnan(score):
        return -math.inf
    return score if higher_is_better else -score


def rank_candidates(scores: Sequence[float],
                    higher_is_better: bool) -> List[int]:
    """rank (0 = best) per candidate index. Stable: equal scores keep
    candidate order, matching MetricEvaluator's first-argmax ``max``."""
    order = sorted(range(len(scores)),
                   key=lambda i: (-_key(scores[i], higher_is_better), i))
    ranks = [0] * len(scores)
    for r, i in enumerate(order):
        ranks[i] = r
    return ranks


def build(instance_id: str, metric_header: str, higher_is_better: bool,
          engine_params_json: Sequence[Dict[str, Any]],
          scores: Sequence[float],
          fold_scores: Optional[Sequence[Sequence[float]]] = None,
          mode: str = "serial", stats: Optional[Dict[str, Any]] = None,
          ) -> Dict[str, Any]:
    """Assemble the versioned leaderboard document. ``entries`` are
    ordered by rank (best first); per-candidate ``index`` preserves the
    generator's candidate order for parity checks against the serial
    result."""
    ranks = rank_candidates(scores, higher_is_better)
    entries = [{
        "rank": ranks[i],
        "index": i,
        "score": None if math.isnan(scores[i]) else float(scores[i]),
        "foldScores": [None if math.isnan(s) else float(s)
                       for s in (fold_scores[i] if fold_scores else [])],
        "engineParams": engine_params_json[i],
    } for i in range(len(scores))]
    entries.sort(key=lambda e: e["rank"])
    doc = {
        "version": LEADERBOARD_VERSION,
        "instanceId": instance_id,
        "metric": metric_header,
        "higherIsBetter": bool(higher_is_better),
        "mode": mode,
        "gridSize": len(scores),
        "createdAt": time.time(),
        "entries": entries,
    }
    doc.update(stats or {})
    return doc


def write(home: str, doc: Dict[str, Any]) -> str:
    """Atomic write (tmp + rename) so a concurrent reader never sees a
    torn leaderboard."""
    d = leaderboard_dir(home)
    os.makedirs(d, exist_ok=True)
    path = leaderboard_path(home, doc["instanceId"])
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, default=str)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read(home: str, instance_id: str) -> Optional[Dict[str, Any]]:
    path = leaderboard_path(home, instance_id)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest(home: str) -> Optional[Dict[str, Any]]:
    """Newest leaderboard by createdAt (mtime tiebreak) under ``home``."""
    d = leaderboard_dir(home)
    if not os.path.isdir(d):
        return None
    best: Optional[Dict[str, Any]] = None
    for name in os.listdir(d):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if best is None or doc.get("createdAt", 0) > best.get("createdAt", 0):
            best = doc
    return best


def digest(doc: Dict[str, Any]) -> str:
    """Stable content digest over (rank, engineParams) — the proof line
    identity: serial and distributed runs that rank the same grid the
    same way share a digest regardless of timing fields."""
    payload = [(e["rank"], e["engineParams"]) for e in doc["entries"]]
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _norm_algo_params(algorithms_params: Any) -> str:
    return json.dumps(algorithms_params, sort_keys=True, default=str)


def candidate_rank_for(doc: Dict[str, Any],
                       algorithms_params: Any) -> Optional[int]:
    """Rank of the entry whose ``algorithmsParams`` match (normalized
    JSON equality), or None when the grid never swept those params."""
    want = _norm_algo_params(algorithms_params)
    for e in doc.get("entries", []):
        got = _norm_algo_params(e.get("engineParams", {})
                                .get("algorithmsParams"))
        if got == want:
            return int(e["rank"])
    return None
