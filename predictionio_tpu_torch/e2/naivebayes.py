"""Categorical Naive Bayes over string-valued features.

The port of the JAX package's ``e2/naivebayes.py`` (reference: e2's
CategoricalNaiveBayes — trains from ``LabeledPoint(label, features)``
where a feature's *position* is the variable and the string its
category; per-label priors, per-(position, value) likelihoods, a
``log_score`` with a pluggable default for unseen values, and
``predict`` = argmax label).

After host-side vocabulary indexing (a BiMap per position), every
(label, position, value) count is one ``index_add_`` on the device (CUDA
unless the caller asks for the CPU) over ``offset[pos] + label·V_pos +
value``, exact in int32; the tables are then built host-side into dicts,
and scoring stays host Python for µs serving.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.segment import segment_count
from predictionio_tpu_torch.utils.bimap import BiMap
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass
class LabeledPoint:
    """A training example: string label + positional string features."""

    label: str
    features: Sequence[str]


@dataclass
class CategoricalNaiveBayesModel:
    """priors[label] = log P(label); likelihoods[label][pos][value] =
    log P(value at pos | label)."""

    priors: Dict[str, float]
    likelihoods: Dict[str, List[Dict[str, float]]]
    #: per-position smoothing floor used for values never seen with a label
    min_log_likelihood: Dict[str, List[float]] = field(default_factory=dict)

    def log_score(
        self,
        point: LabeledPoint,
        default_likelihood: Optional[Callable[[List[float]], float]] = None,
    ) -> Optional[float]:
        """Log joint score of ``point`` under its label, or None if the
        label is unknown. ``default_likelihood`` maps the position's
        known log-likelihood values to a score for an unseen value
        (default: the smoothed floor)."""
        if point.label not in self.priors:
            return None
        pos_tables = self.likelihoods[point.label]
        total = self.priors[point.label]
        for pos, value in enumerate(point.features):
            table = pos_tables[pos]
            if value in table:
                total += table[value]
            elif default_likelihood is not None:
                total += default_likelihood(list(table.values()))
            else:
                total += self.min_log_likelihood[point.label][pos]
        return total

    def predict(self, features: Sequence[str]) -> str:
        """argmax over labels of log_score (reference: predict)."""
        best_label, best = "", -math.inf
        for label in self.priors:
            score = self.log_score(LabeledPoint(label, features))
            if score is not None and score > best:
                best_label, best = label, score
        return best_label


def count_tables(y: np.ndarray, xs: Sequence[np.ndarray], n_labels: int,
                 sizes: Sequence[int], device=None
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Label counts (C,) and per-position (C, V_pos) value counts, int32,
    from dense label ids ``y`` and per-position value ids ``xs``, in one
    segment count on ``device``."""
    dev = resolve_device(device)
    C = int(n_labels)
    offsets = np.concatenate([[0], np.cumsum([C * int(v) for v in sizes])])
    yd = torch.as_tensor(np.asarray(y, np.int64)).to(dev)
    flat = torch.cat(
        [yd * int(v) + torch.as_tensor(np.asarray(x, np.int64)).to(dev) + int(off)
         for x, v, off in zip(xs, sizes, offsets[:-1])]
        + [yd + int(offsets[-1])])
    counts = segment_count(flat, int(offsets[-1]) + C).cpu().numpy()
    mats = [counts[offsets[i]:offsets[i + 1]].reshape(C, int(v))
            for i, v in enumerate(sizes)]
    return counts[offsets[-1]:], mats


def categorical_naive_bayes_train(
    points: Sequence[LabeledPoint], smoothing: float = 1.0, device=None,
) -> CategoricalNaiveBayesModel:
    """Count-and-normalize with additive smoothing; the counts on
    ``device``, the tables on the host."""
    if not points:
        raise ValueError("categorical_naive_bayes_train: no training points")
    n_pos = len(points[0].features)
    for p in points:
        if len(p.features) != n_pos:
            raise ValueError("all points must have the same number of features")

    labels = BiMap.string_int(sorted({p.label for p in points}))
    pos_vocabs = [
        BiMap.string_int(sorted({p.features[i] for p in points}))
        for i in range(n_pos)
    ]
    y = np.asarray([labels[p.label] for p in points], np.int32)
    xs = [np.asarray([vocab[p.features[i]] for p in points], np.int32)
          for i, vocab in enumerate(pos_vocabs)]
    label_counts, count_mats = count_tables(
        y, xs, len(labels), [len(v) for v in pos_vocabs], device)
    # f32 counts: the tables' arithmetic below is then the JAX package's
    label_counts = label_counts.astype(np.float32)
    count_mats = [m.astype(np.float32) for m in count_mats]

    n = float(len(points))
    priors = {lab: math.log(label_counts[idx] / n)
              for lab, idx in labels.to_dict().items()}
    likelihoods: Dict[str, List[Dict[str, float]]] = {}
    floors: Dict[str, List[float]] = {}
    for lab, ci in labels.to_dict().items():
        tables, lab_floors = [], []
        for i, vocab in enumerate(pos_vocabs):
            Vp = len(vocab.keys())
            denom = label_counts[ci] + smoothing * Vp
            table = {
                val: math.log((count_mats[i][ci, vi] + smoothing) / denom)
                for val, vi in vocab.to_dict().items()
            }
            tables.append(table)
            lab_floors.append(math.log(smoothing / denom))
        likelihoods[lab] = tables
        floors[lab] = lab_floors
    return CategoricalNaiveBayesModel(priors, likelihoods, floors)
