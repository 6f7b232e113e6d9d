"""Self-attentive sequential recommendation (SASRec-style next-item model).

The port of the JAX package's ``models/seq_rec.py``: item + position
embeddings, a stack of causal self-attention + pointwise-FFN blocks with
pre-layernorm and residuals, next-item scoring by inner product with the
tied item embedding table. Item id 0 is PAD; real items are 1..n_items.

What keeps it the JAX model, step for step:

- :func:`init_params` and :func:`make_training_batches` draw only from
  ``np.random.default_rng(seed)``, copied, so both packages start from
  bitwise the same weights and batches;
- :class:`SeqRecNet` holds the JAX package's leaves under its names and
  layouts (``wq`` is (in, out): ``h @ wq``); layer norm takes eps 1e-6;
  the item table has no padding row, so row 0 gets gradient through the
  tied logits' softmax; the input is scaled by √d and padded positions
  are zeroed after every block; attention is
  ``parallel/ring_attention.attention_reference`` (fully masked rows give
  zeros);
- the loss is the mean masked next-item cross-entropy, plus ``l2`` times
  the squares of every leaf;
- :class:`Adam` is optax's ``inject_hyperparams(adam)``: ε outside the
  square root, bias-corrected moments, the learning rate in the state
  (this run's wins on resume);
- every product runs in f32 at full precision (no TF32).

Training is an eager loop of steps on the device (the JAX package scans
the whole run in one program); mid-train checkpoints go through the
port's ``utils/checkpoint.TrainCheckpointer``. Serving keeps a
:class:`SeqRecNet` resident on the device (:func:`seq_rec_scores`).
Weights cross between the packages as the JAX package's nested dict of
numpy arrays (:func:`seq_rec_params_from_jax`, :func:`seq_rec_params_to_jax`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from predictionio_tpu_torch.parallel.ring_attention import attention_reference
from predictionio_tpu_torch.utils.device import full_f32, resolve_device


@dataclass
class SeqRecParams:
    """num_blocks/num_heads/hidden per SASRec defaults; seq_len is the
    model's fixed context window (sequences are left-truncated/padded)."""

    hidden: int = 64
    num_blocks: int = 2
    num_heads: int = 2
    seq_len: int = 64
    # the model is deterministic (no dropout): serving parity matters
    # more here than SASRec's 0.2 dropout
    lr: float = 1e-3
    epochs: int = 20
    batch_size: int = 128
    l2: float = 0.0
    seed: int = 7
    # mid-train checkpoint/resume: save params + optimizer state every
    # N epochs; a restarted train with the same dir resumes from the
    # newest checkpoint and (batches are fixed per seed) produces the
    # same final model as an uninterrupted run. None disables.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1


def init_params(n_items: int, p: SeqRecParams) -> Dict:
    """Parameter pytree. Vocabulary row 0 is PAD (zeroed, masked out)."""
    rng = np.random.default_rng(p.seed)
    d, V = p.hidden, n_items + 1

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    item_emb = dense((V, d), 0.02)
    item_emb[0] = 0.0
    params = {
        "item_emb": item_emb,
        "pos_emb": dense((p.seq_len, d), 0.02),
        "blocks": [],
        "ln_f": {"g": np.ones(d, np.float32), "b": np.zeros(d, np.float32)},
    }
    for _ in range(p.num_blocks):
        params["blocks"].append({
            "ln1": {"g": np.ones(d, np.float32), "b": np.zeros(d, np.float32)},
            "wq": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
            "wo": dense((d, d)),
            "ln2": {"g": np.ones(d, np.float32), "b": np.zeros(d, np.float32)},
            "w1": dense((d, 4 * d)), "b1": np.zeros(4 * d, np.float32),
            "w2": dense((4 * d, d)), "b2": np.zeros(d, np.float32),
        })
    return params


def _leaf_paths(params: Dict) -> List[Tuple[str, ...]]:
    """The leaves' paths in ``jax.tree.leaves`` order (dict keys sorted,
    list entries in order)."""
    out: List[Tuple[str, ...]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + (str(i),))
        else:
            out.append(path)

    walk(params, ())
    return out


def _get(params, path):
    for key in path:
        params = params[int(key)] if isinstance(params, (list, tuple)) else params[key]
    return params


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


class SeqRecNet(nn.Module):
    """The model's leaves as parameters, named by their JAX paths joined
    with ``__`` (``blocks__0__wq``), in ``jax.tree.leaves`` order."""

    def __init__(self, params: Dict, p: SeqRecParams, device=None) -> None:
        super().__init__()
        self.hp = p
        self.paths = _leaf_paths(params)
        for path in self.paths:
            self.register_parameter(
                "__".join(path),
                nn.Parameter(torch.from_numpy(np.array(_get(params, path), np.float32))
                             .to(device)))

    def leaf(self, *path: str) -> torch.Tensor:
        return getattr(self, "__".join(path))

    def leaves(self) -> List[torch.Tensor]:
        return [self.leaf(*path) for path in self.paths]

    def forward(self, seqs: torch.Tensor) -> torch.Tensor:
        """[B, S] int item ids (0=pad) → [B, S, d] contextual states."""
        p = self.hp
        B, S = seqs.shape
        d, H = p.hidden, p.num_heads
        Dh = d // H
        k_mask = seqs > 0            # [B, S]: pad positions never serve as keys
        mask = k_mask[..., None]     # [B, S, 1]
        item_emb = self.leaf("item_emb")
        x = item_emb[seqs] * math.sqrt(d) + self.leaf("pos_emb")[None, :S]
        x = x * mask
        for i in range(p.num_blocks):
            blk = lambda *name: self.leaf("blocks", str(i), *name)  # noqa: E731
            h = _ln(x, blk("ln1", "g"), blk("ln1", "b"))
            q = (h @ blk("wq")).reshape(B, S, H, Dh)
            k = (h @ blk("wk")).reshape(B, S, H, Dh)
            v = (h @ blk("wv")).reshape(B, S, H, Dh)
            att = attention_reference(q, k, v, causal=True, k_mask=k_mask)
            x = x + att.reshape(B, S, d) @ blk("wo")
            h = _ln(x, blk("ln2", "g"), blk("ln2", "b"))
            x = x + torch.relu(h @ blk("w1") + blk("b1")) @ blk("w2") + blk("b2")
            x = x * mask
        return _ln(x, self.leaf("ln_f", "g"), self.leaf("ln_f", "b")) * mask

    def scores(self, seqs: torch.Tensor) -> torch.Tensor:
        """[B, S] histories → [B, V] next-item logits."""
        return self(seqs)[:, -1] @ self.leaf("item_emb").T


def seq_rec_params_from_jax(params: Dict, p: SeqRecParams, device=None) -> SeqRecNet:
    """The JAX package's nested dict of (numpy) arrays → a
    :class:`SeqRecNet` on ``device`` (the CPU unless named)."""
    return SeqRecNet(params, p, "cpu" if device is None else device)


def seq_rec_params_to_jax(net: SeqRecNet) -> Dict:
    """A :class:`SeqRecNet` → the JAX package's nested dict of numpy
    arrays (``blocks`` a list)."""
    out: Dict[str, Any] = {}
    for path, t in zip(net.paths, net.leaves()):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().cpu().numpy().copy()
    out["blocks"] = [out["blocks"][str(i)] for i in range(len(out.get("blocks", {})))]
    return out


def _loss(net: SeqRecNet, seqs: torch.Tensor, targets: torch.Tensor,
          l2: Optional[float] = None) -> torch.Tensor:
    """Mean masked cross-entropy of next-item prediction (targets[b, t]
    the next id, 0 where padded), plus ``l2`` (default ``hp.l2``) times
    the sum of every leaf's squares when it is set."""
    states = net(seqs)                                  # [B, S, d]
    logits = states @ net.leaf("item_emb").T            # [B, S, V] tied weights
    logp = torch.log_softmax(logits, dim=-1)
    tgt_logp = logp.gather(-1, targets[..., None])[..., 0]
    m = (targets > 0).to(torch.float32)
    loss = -(tgt_logp * m).sum() / torch.clamp_min(m.sum(), 1.0)
    reg = net.hp.l2 if l2 is None else l2
    if l2 is not None or net.hp.l2:
        loss = loss + reg * sum(torch.sum(w ** 2) for w in net.leaves())
    return loss


def make_training_batches(sequences, p: SeqRecParams, seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side prep: list of per-user item-id lists → fixed-shape
    (inputs [N, S], targets [N, S]) with left-padding, shuffled and
    padded to a whole number of batches."""
    S = p.seq_len
    rows = []
    for seq in sequences:
        seq = [i for i in seq if i > 0]
        if len(seq) >= 2:
            rows.append(seq[-(S + 1):])
    if not rows:
        raise ValueError("no trainable sequences (all shorter than 2)")
    # left-padded in place: the same arrays as padding each row alone
    X = np.zeros((len(rows), S), np.int32)
    Y = np.zeros((len(rows), S), np.int32)
    for r, seq in enumerate(rows):
        X[r, S - len(seq) + 1:] = seq[:-1]
        Y[r, S - len(seq) + 1:] = seq[1:]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(X))
    X, Y = X[order], Y[order]
    bs = min(p.batch_size, len(X))
    n_batches = -(-len(X) // bs)
    padn = n_batches * bs - len(X)
    if padn:  # repeat leading rows: keeps shapes static, loss still masked
        X = np.concatenate([X, X[:padn]])
        Y = np.concatenate([Y, Y[:padn]])
    return X.reshape(n_batches, bs, S), Y.reshape(n_batches, bs, S)


class Adam:
    """optax's ``inject_hyperparams(adam)(learning_rate)`` over a list of
    leaves, operation for operation in f32. As there, β1 = 0.9, β2 =
    0.999 and ε = 1e-8 are f32 values (so ``1 - β`` and the bias
    corrections ``1 - βᵗ`` are taken in f32): ``mu = (1-β1)·g + β1·mu``,
    ``nu = (1-β2)·g² + β2·nu``, ``p += (mu/(1-β1ᵗ)) / (√(nu/(1-β2ᵗ)) + ε) ·
    -lr`` (ε outside the square root). The learning rate and the step
    count live in the state."""

    b1, b2, eps = np.float32(0.9), np.float32(0.999), np.float32(1e-8)

    def __init__(self, leaves: List[torch.Tensor], lr: float) -> None:
        self.leaves = leaves
        self.mu = [torch.zeros_like(t) for t in leaves]
        self.nu = [torch.zeros_like(t) for t in leaves]
        self.count = 0
        self.lr = float(np.float32(lr))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        one = np.float32(1.0)
        bc1 = float(one - self.b1 ** np.float32(self.count))
        bc2 = float(one - self.b2 ** np.float32(self.count))
        torch._foreach_mul_(self.mu, float(self.b1))
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, float(one - self.b1)))
        torch._foreach_mul_(self.nu, float(self.b2))
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), float(one - self.b2)))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, float(self.eps))
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.leaves, upd)

    # -- checkpoint state: optax's InjectHyperparamsState fields ---------------

    def state(self, paths) -> Dict[str, Any]:
        def tree(ts):
            return {"__".join(path): t.detach().cpu().numpy().copy()
                    for path, t in zip(paths, ts)}

        return {"count": np.asarray(self.count, np.int32),
                "learning_rate": np.asarray(self.lr, np.float32),
                "mu": tree(self.mu), "nu": tree(self.nu)}

    def load_state(self, state: Dict[str, Any], paths) -> None:
        """Restore moments and step count; the learning rate stays this
        run's."""
        self.count = int(state["count"])
        with torch.no_grad():
            for key, ts in (("mu", self.mu), ("nu", self.nu)):
                for path, t in zip(paths, ts):
                    t.copy_(torch.from_numpy(np.asarray(state[key]["__".join(path)])))


def _net_state(net: SeqRecNet, opt: Adam) -> Dict[str, Any]:
    return {"params": {"__".join(path): t.detach().cpu().numpy().copy()
                       for path, t in zip(net.paths, net.leaves())},
            "opt_state": opt.state(net.paths)}


def _load_net_state(net: SeqRecNet, opt: Adam, state: Dict[str, Any]) -> None:
    with torch.no_grad():
        for path, t in zip(net.paths, net.leaves()):
            t.copy_(torch.from_numpy(np.asarray(state["params"]["__".join(path)])))
    opt.load_state(state["opt_state"], net.paths)


def train_steps(net: SeqRecNet, opt: Adam, X: torch.Tensor, Y: torch.Tensor,
                l2: Optional[float] = None) -> torch.Tensor:
    """One epoch: an Adam step for each batch of (X, Y), [n_batches, B, S]
    on the net's device; returns the epoch's mean loss (device scalar)."""
    losses = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for b in range(X.shape[0]):
        loss = _loss(net, X[b], Y[b], l2)
        grads = torch.autograd.grad(loss, net.leaves())
        opt.step(list(grads))
        losses[b] = loss.detach()
    return losses.mean()


def seq_rec_train(sequences, n_items: int, p: SeqRecParams, device=None
                  ) -> Tuple[Dict, np.ndarray]:
    """Train on per-user item-id sequences on ``device`` (CUDA unless the
    caller passes "cpu"); returns (params as the JAX package's nested
    dict of numpy arrays, mean loss of each epoch run).

    With ``p.checkpoint_dir`` the state (parameters, moments, step count and
    learning rate) is saved every ``checkpoint_every`` epochs and a
    restarted run resumes from the newest compatible step with THIS
    run's learning rate; a checkpoint of another geometry is wiped with
    a warning. A resumed run returns the losses of the epochs it ran."""
    dev = resolve_device(device)
    X, Y = make_training_batches(sequences, p, seed=p.seed)
    net = SeqRecNet(init_params(n_items, p), p, dev)
    opt = Adam(net.leaves(), p.lr)
    Xd = torch.from_numpy(X.astype(np.int64)).to(dev)
    Yd = torch.from_numpy(Y.astype(np.int64)).to(dev)
    l2 = float(np.float32(p.l2)) if p.l2 else None

    ckpt = None
    start = 0
    if p.checkpoint_dir:
        from predictionio_tpu_torch.utils.checkpoint import (
            CheckpointGeometryError,
            TrainCheckpointer,
        )

        ckpt = TrainCheckpointer(p.checkpoint_dir)
        if ckpt.latest_step() is not None:
            try:
                # newest→oldest walk: a crash-truncated newest save falls
                # back to the previous good step
                state, latest = ckpt.restore_latest_compatible(_net_state(net, opt))
                _load_net_state(net, opt, state)
                start = min(int(latest), p.epochs)
            except CheckpointGeometryError:
                # CONFIRMED stale (another geometry) → fresh start; wipe
                # so the stale latest step can't shadow this run's saves.
                # Transient read errors propagate.
                import warnings

                warnings.warn(
                    "seq_rec checkpoints are stale (geometry/format change) — wiped; training restarts from scratch",
                    RuntimeWarning)
                ckpt.clear()
    losses = []
    with full_f32():
        for epoch in range(start, p.epochs):
            losses.append(train_steps(net, opt, Xd, Yd, l2))
            if ckpt is not None and (
                    (epoch + 1 - start) % max(1, p.checkpoint_every) == 0
                    or epoch + 1 == p.epochs):
                ckpt.save(epoch + 1, _net_state(net, opt))
    if ckpt is not None:
        ckpt.close()
    return (seq_rec_params_to_jax(net),
            torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32))


def seq_rec_scores(params, history, p: SeqRecParams, device=None) -> np.ndarray:
    """Scores over the full vocabulary for the NEXT item after ``history``
    (a list of item ids); [V] numpy array, PAD row = -inf. ``params`` is
    a resident :class:`SeqRecNet` (scored on its device) or the JAX
    package's nested dict (moved to ``device`` for this call)."""
    net = params if isinstance(params, SeqRecNet) else SeqRecNet(
        params, p, resolve_device(device))
    S = p.seq_len
    seq = [i for i in history if i > 0][-S:]
    x = np.zeros((1, S), np.int64)
    if seq:
        x[0, S - len(seq):] = seq
    dev = net.leaf("item_emb").device
    with torch.no_grad(), full_f32():
        logits = net.scores(torch.from_numpy(x).to(dev))[0].cpu().numpy()
    logits[0] = -np.inf
    return logits
