"""Per-variant online scoring from the live feedback stream (the port's
copy of the JAX package's ``server/variant_metrics.py``).

The offline guardrail (the JAX package's ``server/trainer.py``) scores a
candidate on a held-out slice; this module closes the ONLINE loop: every served query
is attributed to the variant that answered it (sticky split —
server/variants.py), the served prediction is remembered by ``prId``,
and feedback that comes back (a rating, a click) accrues into
per-variant Prometheus series the promotion gate can read live:

- ``pio_variant_requests_total{variant,status}`` — dispatch share
- ``pio_variant_request_seconds{variant}``       — per-arm latency
  (histogram, with trace exemplars)
- ``pio_variant_feedback_total{variant,kind}``   — feedback volume
- ``pio_variant_online_rmse{variant}``           — accrued rating RMSE
  (predicted score at serve time vs the rating that came back)
- ``pio_variant_ctr{variant}``                   — clicks / served

The JAX package's ``pio train --continuous --gate online`` scrapes
exactly these names (``ContinuousTrainer._guardrail_online``), and a
port server is scraped alike; renaming a series is a
breaking change to the promotion gate.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

from predictionio_tpu_torch.utils import tracing
from predictionio_tpu_torch.utils.metrics import REGISTRY

_REQUESTS = REGISTRY.counter(
    "pio_variant_requests_total",
    "Queries dispatched per resident variant", ("variant", "status"))
_LATENCY = REGISTRY.histogram(
    "pio_variant_request_seconds",
    "Per-variant query latency (handler, seconds)",
    labelnames=("variant",))
_FEEDBACK = REGISTRY.counter(
    "pio_variant_feedback_total",
    "Feedback events attributed per variant", ("variant", "kind"))
_ONLINE_RMSE = REGISTRY.gauge(
    "pio_variant_online_rmse",
    "Accrued online rating RMSE per variant (live feedback)",
    labelnames=("variant",))
_CTR = REGISTRY.gauge(
    "pio_variant_ctr",
    "Accrued click-through rate per variant (clicks / served)",
    labelnames=("variant",))


class VariantScoreboard:
    """Attribution + accrual for one replica's resident variant set.

    Thread contract: requests are observed from the event loop, feedback
    may arrive from the feedback worker pool — every mutation holds one
    lock. The served-prediction map is bounded (oldest ``prId`` evicted
    first), so a feedback stream that never closes the loop cannot grow
    memory.
    """

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        #: prId -> (variant, {item: predicted score}, top predicted score)
        self._served: "OrderedDict[str, tuple]" = OrderedDict()
        self._stats: Dict[str, Dict[str, float]] = {}

    def _bucket(self, variant: str) -> Dict[str, float]:
        return self._stats.setdefault(variant, {
            "served": 0.0, "clicks": 0.0, "feedback": 0.0,
            "se_sum": 0.0, "se_n": 0.0})

    # -- serve side ---------------------------------------------------------

    def observe_request(self, variant: str, seconds: float,
                        status: str) -> None:
        _REQUESTS.inc((variant, status))
        _LATENCY.observe(seconds, (variant,), exemplar=tracing.exemplar())
        if status != "200":
            return
        with self._lock:
            st = self._bucket(variant)
            st["served"] += 1
            if st["served"] > 0:
                _CTR.set(st["clicks"] / st["served"], (variant,))

    def record_served(self, pr_id: str, variant: str,
                      prediction: Any) -> None:
        """Remember what was served under this ``prId`` so feedback can
        be attributed and scored later."""
        scores: Dict[str, float] = {}
        top: Optional[float] = None
        if isinstance(prediction, dict):
            for e in (prediction.get("itemScores") or []):
                try:
                    scores[str(e["item"])] = float(e["score"])
                except (KeyError, TypeError, ValueError):
                    continue
            if scores:
                top = next(iter(scores.values()))
        with self._lock:
            self._served[pr_id] = (variant, scores, top)
            while len(self._served) > self.capacity:
                self._served.popitem(last=False)

    # -- feedback side ------------------------------------------------------

    def resolve(self, pr_id: Optional[str]) -> Optional[str]:
        """Which variant served this ``prId`` (None if unknown/evicted)."""
        if not pr_id:
            return None
        with self._lock:
            rec = self._served.get(pr_id)
        return rec[0] if rec else None

    def observe_feedback(self, pr_id: Optional[str] = None,
                         variant: Optional[str] = None,
                         rating: Optional[float] = None,
                         item: Optional[str] = None,
                         clicked: Optional[bool] = None) -> Optional[str]:
        """Accrue one feedback event. The variant comes from the event
        itself (serving tagged it) or from the ``prId`` map. A rating is
        scored against the PREDICTED score remembered at serve time
        (per-item when the rated item was in the served list, else the
        top score). Returns the attributed variant, or None when the
        event cannot be attributed (dropped, counted nowhere)."""
        scores: Dict[str, float] = {}
        top: Optional[float] = None
        if pr_id:
            with self._lock:
                rec = self._served.get(pr_id)
            if rec:
                variant = variant or rec[0]
                scores, top = rec[1], rec[2]
        if not variant:
            return None
        kind = ("rating" if rating is not None
                else "click" if clicked else "event")
        _FEEDBACK.inc((variant, kind))
        with self._lock:
            st = self._bucket(variant)
            st["feedback"] += 1
            if clicked:
                st["clicks"] += 1
                if st["served"] > 0:
                    _CTR.set(st["clicks"] / st["served"], (variant,))
            if rating is not None:
                predicted = scores.get(str(item)) if item else None
                if predicted is None:
                    predicted = top
                if predicted is not None:
                    st["se_sum"] += (predicted - float(rating)) ** 2
                    st["se_n"] += 1
                    _ONLINE_RMSE.set(
                        math.sqrt(st["se_sum"] / st["se_n"]), (variant,))
        return variant

    # -- observability ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {}
            for variant, st in sorted(self._stats.items()):
                rmse = (math.sqrt(st["se_sum"] / st["se_n"])
                        if st["se_n"] else None)
                out[variant] = {
                    "served": int(st["served"]),
                    "feedback": int(st["feedback"]),
                    "clicks": int(st["clicks"]),
                    "ctr": (round(st["clicks"] / st["served"], 6)
                            if st["served"] else None),
                    "onlineRmse": round(rmse, 6) if rmse is not None else None,
                    "ratedPairs": int(st["se_n"]),
                }
            return out
