"""Logistic regression (multinomial) on the card.

The port of the JAX package's ``models/linear.py`` (MLlib's
``LogisticRegressionWithLBFGS`` of the reference's classification
template). Full-batch training on the training device through
:mod:`.lbfgs`, the port's copy of ``optax.lbfgs()`` and ``optax.adam``:
exactly ``iterations`` steps from zero weights on the loss

    mean_i (logsumexp(x_i W + b) − (x_i W + b)[y_i]) + 0.5 · reg · ΣW²

with its gradient written out (``X``ᵀ``(softmax − onehot) / n + reg·W``)
in f32 at full precision (no TF32). The JAX package vmaps a grid of
candidates into one program; the port trains them one after another over
one uploaded batch, with the same per-candidate result. Prediction is
host numpy, as the JAX package serves.

Over a mesh of more than one slot the batch is data-parallel, as the JAX
package shards it over ``"data"``: zero rows pad n to a multiple of the
slots, each slot holds its rows, and every evaluation of the loss sums
the slots' masked losses and gradients onto the first slot in slot order
(the JAX package's gradient ``psum``), divided by the true n, before the
host-side line search of :mod:`.lbfgs`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.models.lbfgs import minimize
from predictionio_tpu_torch.utils.device import full_f32, resolve_device


@dataclass
class LogisticRegressionParams:
    num_classes: int = 2
    iterations: int = 100
    reg: float = 0.0           # L2
    learning_rate: float = 0.1  # used by the adam fallback
    optimizer: str = "lbfgs"   # "lbfgs" | "adam"
    seed: int = 0


def loss_and_grad(Xd: torch.Tensor, yd: torch.Tensor, C: int, reg: float):
    """The loss of a flat parameter vector ``[W.ravel(), b]`` and its
    gradient, on the batch's device."""
    n, d = Xd.shape
    onehot = torch.nn.functional.one_hot(yd, C).float()
    reg = float(np.float32(reg))

    def value_and_grad(theta: torch.Tensor):
        W = theta[:d * C].view(d, C)
        b = theta[d * C:]
        with full_f32():
            logits = Xd @ W + b
            ll = torch.logsumexp(logits, 1) - logits.gather(1, yd[:, None])[:, 0]
            value = ll.sum() / n + 0.5 * reg * (W * W).sum()
            G = (torch.softmax(logits, 1) - onehot) / n
            gW = Xd.T @ G + reg * W
        return value, torch.cat([gW.reshape(-1), G.sum(0)])

    return value_and_grad


def sharded_loss_and_grad(shares: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                          n: int, C: int, reg: float, home: torch.device):
    """:func:`loss_and_grad` over data-parallel ``shares`` (each slot's
    rows, labels and the mask of its real rows, on the slot): each slot's
    masked loss sum and gradient, summed onto ``home`` in slot order and
    divided by the true row count ``n``."""
    reg = float(np.float32(reg))
    d = shares[0][0].shape[1]
    onehots = [torch.nn.functional.one_hot(ys, C).float() for _, ys, _ in shares]

    def value_and_grad(theta: torch.Tensor):
        W = theta[:d * C].view(d, C)
        b = theta[d * C:]
        total = torch.zeros((), dtype=torch.float32, device=home)
        gW = torch.zeros_like(W)
        gb = torch.zeros_like(b)
        with full_f32():
            for (Xs, ys, ms), oh in zip(shares, onehots):
                Ws, bs = W.to(Xs.device), b.to(Xs.device)
                logits = Xs @ Ws + bs
                ll = torch.logsumexp(logits, 1) - logits.gather(1, ys[:, None])[:, 0]
                G = (torch.softmax(logits, 1) - oh) * ms[:, None] / n
                total = total + (ll * ms).sum().to(home)
                gW = gW + (Xs.T @ G).to(home)
                gb = gb + G.sum(0).to(home)
            value = total / n + 0.5 * reg * (W * W).sum()
            gW = gW + reg * W
        return value, torch.cat([gW.reshape(-1), gb])

    return value_and_grad


def _put(X: np.ndarray, y: np.ndarray, dev: torch.device):
    return (torch.as_tensor(np.ascontiguousarray(X, np.float32)).to(dev),
            torch.as_tensor(np.ascontiguousarray(y, np.int64)).to(dev))


def data_shares(X: np.ndarray, y: np.ndarray, slots
                ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The batch split over ``slots``: zero rows pad n to a multiple of
    the slot count, and each slot gets (rows, labels, real-row mask) on
    its device."""
    n, S = len(y), len(slots)
    pad = (-n) % S
    X = np.concatenate([np.asarray(X, np.float32),
                        np.zeros((pad,) + X.shape[1:], np.float32)])
    y = np.concatenate([np.asarray(y, np.int64), np.zeros(pad, np.int64)])
    real = np.arange(n + pad) < n
    per = (n + pad) // S
    out = []
    for s, dev in enumerate(slots):
        rows = slice(s * per, (s + 1) * per)
        Xs, ys = _put(X[rows], y[rows], dev)
        out.append((Xs, ys, torch.as_tensor(real[rows], dtype=torch.float32).to(dev)))
    return out


def _slots(mesh, what: str) -> Optional[list]:
    """The data-parallel slots of ``mesh`` (None: one device)."""
    if mesh is None or mesh.size <= 1:
        return None
    from predictionio_tpu_torch.parallel.mesh import process_slots

    return process_slots(mesh, what)


def _train(value_and_grad, home: torch.device, d: int, C: int, iterations: int,
           learning_rate: float, optimizer: str) -> Tuple[torch.Tensor, torch.Tensor]:
    theta = minimize(value_and_grad,
                     torch.zeros(d * C + C, dtype=torch.float32, device=home),
                     int(iterations), use_lbfgs=optimizer == "lbfgs",
                     learning_rate=learning_rate)
    return theta[:d * C].view(d, C), theta[d * C:]


def _train_on(Xd: torch.Tensor, yd: torch.Tensor, C: int, iterations: int,
              reg: float, learning_rate: float, optimizer: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _train(loss_and_grad(Xd, yd, C, reg), Xd.device, Xd.shape[1], C,
                  iterations, learning_rate, optimizer)


def logreg_train(
    X: np.ndarray, y: np.ndarray, params: LogisticRegressionParams,
    device=None, mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train on ``device`` (CUDA unless the caller passes "cpu"), or
    data-parallel over the slots of ``mesh`` when it has more than one;
    returns (W [d, C], b [C]) as float32 numpy."""
    slots = _slots(mesh, "data-parallel logistic regression")
    p = params
    if slots is None:
        Xd, yd = _put(X, y, resolve_device(device))
        W, b = _train_on(Xd, yd, p.num_classes, p.iterations, p.reg,
                         p.learning_rate, p.optimizer)
    else:
        home = resolve_device(slots[0])
        vg = sharded_loss_and_grad(data_shares(X, y, slots), len(y),
                                   p.num_classes, p.reg, home)
        W, b = _train(vg, home, X.shape[1], p.num_classes, p.iterations,
                      p.learning_rate, p.optimizer)
    return W.cpu().numpy(), b.cpu().numpy()


def logreg_train_many(
    X: np.ndarray, y: np.ndarray,
    params_list: Sequence[LogisticRegressionParams], device=None, mesh=None,
) -> list:
    """Train k candidates on the SAME batch — the ``pio eval`` grid
    fan-out — uploaded once, the candidates one after another; returns
    ``[(W, b), ...]`` in ``params_list``'s order. Over a mesh of more
    than one slot each candidate trains data-parallel through
    :func:`logreg_train` (the JAX package's un-stacked path)."""
    if _slots(mesh, "data-parallel logistic regression") is not None:
        return [logreg_train(X, y, p, mesh=mesh) for p in params_list]
    dev = resolve_device(device)
    Xd, yd = _put(X, y, dev)
    out = []
    for p in params_list:
        W, b = _train_on(Xd, yd, p.num_classes, p.iterations, p.reg,
                         p.learning_rate, p.optimizer)
        out.append((W.cpu().numpy(), b.cpu().numpy()))
    return out


def logreg_train_scored(num_classes: int, iterations: int, use_lbfgs: bool):
    """The train+score half of the distributed sweep (core/sweep.py):
    ``one(hyper, Xd, yd, Xe, ye) -> (correct, count)`` with ``hyper =
    [reg, learning_rate]`` one row of the stacked grid; the loss and
    optimizer are :func:`logreg_train`'s, and the held-out rows are
    scored on the device."""

    def one(hyper, Xd, yd, Xe, ye):
        W, b = _train_on(Xd, yd, num_classes, iterations, float(hyper[0]),
                         float(hyper[1]), "lbfgs" if use_lbfgs else "adam")
        with full_f32():
            pred = torch.argmax(Xe @ W + b, dim=-1)
        return (pred == ye).float().sum(), float(ye.shape[0])

    return one


def logreg_sweep_program(X: np.ndarray, y: np.ndarray, Xe: np.ndarray,
                         ye: np.ndarray, num_classes: int, iterations: int,
                         optimizer: str = "lbfgs", device=None):
    """The ``(geometry, build, data)`` triple core/sweep.py's SweepProgram
    wants for a bucket of logreg candidates sharing (num_classes,
    iterations, optimizer), on ``device``. Hyper rows are ``[reg,
    learning_rate]``."""
    dev = resolve_device(device)
    use_lbfgs = optimizer == "lbfgs"
    geometry = ("logreg_scored", int(num_classes), int(X.shape[1]),
                int(iterations), bool(use_lbfgs), tuple(X.shape),
                tuple(Xe.shape), str(dev))
    data = (*_put(X, y, dev), *_put(Xe, ye, dev))

    def build():
        return logreg_train_scored(int(num_classes), int(iterations), use_lbfgs)

    return geometry, build, data


def logreg_predict(W: np.ndarray, b: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Class indices for rows of X."""
    return np.argmax(X @ W + b, axis=-1)


def logreg_predict_proba(W: np.ndarray, b: np.ndarray, X: np.ndarray) -> np.ndarray:
    z = X @ W + b
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)
