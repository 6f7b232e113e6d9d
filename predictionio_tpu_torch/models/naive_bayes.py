"""Naive Bayes (multinomial / bernoulli) on the card.

The port of the JAX package's ``models/naive_bayes.py`` (MLlib's
``NaiveBayes`` of the reference's classification template). The
per-class aggregation is one one-hot matmul ``Yᵀ X`` in f32 at full
precision (no TF32) on the training device; the smoothing and
log-normalisation are the JAX package's formulas (λ additive smoothing).
Scoring (:func:`nb_predict`) is host numpy, as the JAX package serves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from predictionio_tpu_torch.utils.device import full_f32, resolve_device


@dataclass
class NaiveBayesParams:
    lambda_: float = 1.0
    model_type: str = "multinomial"  # or "bernoulli"
    num_classes: int = 0  # 0 → infer from labels


def _fit(Xd: torch.Tensor, yd: torch.Tensor, C: int, lam, bern: bool):
    """(log_prior (C,), log_theta (C, d)) on the tensors' device; ``lam``
    is a float or a 0-d tensor."""
    d = Xd.shape[1]
    Xb = (Xd > 0).float() if bern else Xd
    Y = torch.nn.functional.one_hot(yd.long(), C).float()  # (n, C)
    class_count = Y.sum(0)                                 # (C,)
    with full_f32():
        feat_sum = Y.T @ Xb                                # (C, d)
    log_prior = (torch.log(class_count + lam)
                 - torch.log(class_count.sum() + C * lam))
    if bern:
        # P(feature on | class), complement handled at predict time
        log_theta = (torch.log(feat_sum + lam)
                     - torch.log(class_count[:, None] + 2.0 * lam))
    else:
        log_theta = (torch.log(feat_sum + lam)
                     - torch.log(feat_sum.sum(1, keepdim=True) + d * lam))
    return log_prior, log_theta


def nb_train(X: np.ndarray, y: np.ndarray, params: NaiveBayesParams,
             device=None, mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Train on ``device`` (CUDA unless the caller passes "cpu"); returns
    (log_prior [C], log_theta [C, d]) as float32 numpy. ``mesh`` is
    accepted and ignored, as the JAX package's ``nb_train`` ignores it:
    the closed-form fit is one matmul on ``device``."""
    dev = resolve_device(device)
    C = params.num_classes or int(y.max()) + 1
    Xd = torch.as_tensor(np.asarray(X, np.float32)).to(dev)
    yd = torch.as_tensor(np.asarray(y, np.int64)).to(dev)
    lp, lt = _fit(Xd, yd, C, float(np.float32(params.lambda_)),
                  params.model_type == "bernoulli")
    return lp.cpu().numpy(), lt.cpu().numpy()


def nb_train_scored(num_classes: int, bernoulli: bool):
    """The train+score half of the distributed sweep (core/sweep.py):
    ``one(hyper, Xd, yd, Xe, ye) -> (correct, count)`` with ``hyper =
    [lambda_]`` one row of the stacked grid. The fit and the
    bernoulli/multinomial scoring are :func:`nb_train`'s and
    :func:`nb_predict`'s, on the device."""
    C = num_classes

    def one(hyper, Xd, yd, Xe, ye):
        lam = float(np.float32(hyper[0]))
        log_prior, log_theta = _fit(Xd, yd, C, lam, bernoulli)
        with full_f32():
            if bernoulli:
                theta = torch.exp(log_theta)
                log_neg = torch.log1p(-theta.clamp(1e-12, 1 - 1e-12))
                Xeb = (Xe > 0).float()
                scores = Xeb @ log_theta.T + (1.0 - Xeb) @ log_neg.T + log_prior
            else:
                scores = Xe @ log_theta.T + log_prior
        pred = torch.argmax(scores, dim=-1)
        return (pred == ye).float().sum(), float(ye.shape[0])

    return one


def nb_sweep_program(X: np.ndarray, y: np.ndarray, Xe: np.ndarray,
                     ye: np.ndarray, num_classes: int, bernoulli: bool,
                     device=None):
    """The ``(geometry, build, data)`` triple core/sweep.py's SweepProgram
    wants for a bucket of NaiveBayes candidates sharing (num_classes,
    model_type), on ``device``. Hyper rows are ``[lambda_]``."""
    dev = resolve_device(device)
    geometry = ("nb_scored", int(num_classes), int(X.shape[1]),
                bool(bernoulli), tuple(X.shape), tuple(Xe.shape), str(dev))

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(dev)

    data = (put(X, np.float32), put(y, np.int64),
            put(Xe, np.float32), put(ye, np.int64))

    def build():
        return nb_train_scored(int(num_classes), bool(bernoulli))

    return geometry, build, data


def nb_predict(log_prior: np.ndarray, log_theta: np.ndarray, X: np.ndarray,
               model_type: str = "multinomial") -> np.ndarray:
    if model_type == "bernoulli":
        Xb = (X > 0).astype(np.float32)
        theta = np.exp(log_theta)
        log_neg = np.log1p(-np.clip(theta, 1e-12, 1 - 1e-12))
        scores = Xb @ log_theta.T + (1.0 - Xb) @ log_neg.T + log_prior
    else:
        scores = X @ log_theta.T + log_prior
    return np.argmax(scores, axis=-1)
