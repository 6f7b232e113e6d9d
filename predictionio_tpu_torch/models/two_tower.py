"""Two-tower retrieval model (PyTorch): user and item ID-embedding towers
with MLP heads, trained with in-batch softmax contrastive loss.

The port of the JAX package's ``models/two_tower.py`` (flax + optax):

- each tower is an ``nn.Module``: ``nn.Embedding`` (initialised N(0,
  0.05)), ``nn.Linear`` + ReLU per hidden width, ``nn.Linear`` to
  ``out_dim``, then ``x / (1e-8 + ‖x‖)`` (cosine retrieval);
- the loss is the in-batch softmax cross-entropy of ``ue · ieᵀ /
  temperature`` against the diagonal;
- ``torch.optim.Adam`` (β 0.9/0.999, ε 1e-8 outside the square root,
  bias-corrected: optax's ``adam``) with DENSE embedding gradients, so
  every row moves from its moments each step as optax moves it; the
  learning rate is set per run (optax's ``inject_hyperparams``);
- epoch permutations come from ``np.random.default_rng(seed + epoch)``
  and the streaming path groups batches ``(G, B)`` with carried
  remainders exactly as the JAX package does, so both packages see the
  same batches in the same order.

Weights cross between the packages as flax variable dicts of numpy
arrays (``{"params": {"Embed_0": {"embedding"}, "Dense_j": {"kernel",
"bias"}}}``; a flax ``Dense`` kernel is (in, out), ``nn.Linear.weight``
(out, in)): :func:`two_tower_variables_from_jax` and
:func:`two_tower_variables_to_jax`. :func:`two_tower_train` returns that
format, which the template's blob stores. Serving embeds with the host
numpy forward (:func:`two_tower_embed_items`, ``_users``) and scores on
the device through the ALS family's scorers or an ANN index
(:func:`two_tower_build_index`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


@dataclass
class TwoTowerParams:
    embed_dim: int = 32
    hidden: List[int] = field(default_factory=lambda: [64])
    out_dim: int = 32
    batch_size: int = 1024
    epochs: int = 5
    learning_rate: float = 0.01
    temperature: float = 0.1
    seed: int = 0
    # mid-train checkpoint/resume: save full state every N epochs; a
    # restarted train with the same dir resumes at the newest epoch.
    # None disables.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    # streaming path: total pair count from the reader's vocabulary
    # pass (avoids an extra counting pass over the event log)
    n_pairs: int = 0


class Tower(nn.Module):
    """ID embedding → (Linear + ReLU) per hidden width → Linear →
    L2-normalised rows."""

    def __init__(self, vocab: int, embed_dim: int, hidden: List[int],
                 out_dim: int) -> None:
        super().__init__()
        self.embed = nn.Embedding(vocab, embed_dim)
        dims = [embed_dim, *hidden]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.out = nn.Linear(dims[-1], out_dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        for lin in self.hidden:
            x = torch.relu(lin(x))
        x = self.out(x)
        return x / (1e-8 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))

    def linears(self) -> List[nn.Linear]:
        """The Dense layers in flax's order (``Dense_0`` …)."""
        return [*self.hidden, self.out]


# -- weights across the packages ----------------------------------------------


def _tower_from_vars(variables: Dict[str, Any], device) -> Tower:
    p = variables["params"]
    emb = np.array(p["Embed_0"]["embedding"], np.float32)
    names = sorted((k for k in p if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    kernels = [np.array(p[n]["kernel"], np.float32) for n in names]
    tower = Tower(emb.shape[0], emb.shape[1],
                  [k.shape[1] for k in kernels[:-1]], kernels[-1].shape[1])
    with torch.no_grad():
        tower.embed.weight.copy_(torch.from_numpy(emb))
        for lin, n, kern in zip(tower.linears(), names, kernels):
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(kern.T)))
            lin.bias.copy_(torch.from_numpy(np.array(p[n]["bias"], np.float32)))
    return tower.to(device)


def _tower_to_vars(tower: Tower) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "Embed_0": {"embedding": tower.embed.weight.detach().cpu().numpy().copy()}}
    for j, lin in enumerate(tower.linears()):
        params[f"Dense_{j}"] = {
            "kernel": np.ascontiguousarray(lin.weight.detach().cpu().numpy().T),
            "bias": lin.bias.detach().cpu().numpy().copy()}
    return {"params": params}


def two_tower_variables_from_jax(user_vars, item_vars, device="cpu"
                                 ) -> Tuple[Tower, Tower]:
    """The port's (user, item) towers on ``device`` from flax variable
    dicts of numpy arrays (the JAX package's ``two_tower_train`` output,
    or the template blob's ``user_vars``)."""
    return _tower_from_vars(user_vars, device), _tower_from_vars(item_vars, device)


def two_tower_variables_to_jax(user: Tower, item: Tower):
    """(user_vars, item_vars) flax variable dicts of numpy arrays."""
    return _tower_to_vars(user), _tower_to_vars(item)


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """N(0, std²) truncated to ±2 std (redrawn), flax's lecun_normal draw
    shape."""
    x = rng.standard_normal(shape)
    while True:
        bad = np.abs(x) > 2.0
        if not bad.any():
            break
        x[bad] = rng.standard_normal(int(bad.sum()))
    return (x * std).astype(np.float32)


def init_variables(n_users: int, n_items: int, p: TwoTowerParams):
    """Seeded initial (user_vars, item_vars), flax's initialisers
    (embedding N(0, 0.05); Dense kernels lecun-normal, truncated at two
    standard deviations; biases 0) drawn from ``np.random.default_rng(
    seed)``. The JAX package draws from ``jax.random``, so the two
    packages' initial weights differ; tests carry one package's weights
    into the other with :func:`two_tower_variables_from_jax`."""
    rng = np.random.default_rng(p.seed)

    def tower(vocab):
        params = {"Embed_0": {"embedding": (
            rng.standard_normal((vocab, p.embed_dim)) * 0.05).astype(np.float32)}}
        dims = [p.embed_dim, *p.hidden, p.out_dim]
        for j, (a, b) in enumerate(zip(dims, dims[1:])):
            # variance_scaling(1, fan_in, truncated_normal): the std of
            # the truncated draw is corrected back to sqrt(1 / fan_in)
            params[f"Dense_{j}"] = {
                "kernel": _truncated_normal(rng, (a, b),
                                            np.sqrt(1.0 / a) / 0.87962566103423978),
                "bias": np.zeros(b, np.float32)}
        return {"params": params}

    return tower(n_users), tower(n_items)


# -- training -----------------------------------------------------------------


class TwoTowerTrainer:
    """Both towers and their Adam state on one device, with the training
    step; the state a checkpoint saves and a resume restores."""

    def __init__(self, user_vars, item_vars, p: TwoTowerParams, device) -> None:
        self.device = device
        self.user, self.item = two_tower_variables_from_jax(user_vars, item_vars,
                                                            device)
        self.temperature = float(np.float32(p.temperature))
        self._params = [*self.user.parameters(), *self.item.parameters()]
        self.opt = torch.optim.Adam(self._params, lr=float(p.learning_rate),
                                    betas=(0.9, 0.999), eps=1e-8)

    def step(self, bu: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
        """One Adam step on the batch (bu, bi) of positive pairs; the
        loss (a device scalar)."""
        ue = self.user(bu)
        ie = self.item(bi)
        logits = (ue @ ie.T) / self.temperature      # in-batch negatives
        labels = torch.arange(bu.shape[0], device=bu.device)
        loss = nn.functional.cross_entropy(logits, labels)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def variables(self):
        return two_tower_variables_to_jax(self.user, self.item)

    # -- checkpoint state -----------------------------------------------------

    def _named(self):
        return ([("user", n, t) for n, t in self.user.named_parameters()]
                + [("item", n, t) for n, t in self.item.named_parameters()])

    def state(self) -> Dict[str, Any]:
        """Parameters, Adam moments and step count as numpy (nested)."""
        out: Dict[str, Any] = {"params": {"user": {}, "item": {}},
                               "exp_avg": {"user": {}, "item": {}},
                               "exp_avg_sq": {"user": {}, "item": {}}}
        step = 0
        for side, name, t in self._named():
            out["params"][side][name] = t.detach().cpu().numpy().copy()
            st = self.opt.state.get(t, {})
            for key in ("exp_avg", "exp_avg_sq"):
                out[key][side][name] = (st[key].detach().cpu().numpy().copy()
                                        if key in st else
                                        np.zeros(tuple(t.shape), np.float32))
            if "step" in st:
                step = int(float(st["step"]))
        out["step"] = np.asarray(step, np.int64)
        return out

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state`'s output exactly (the learning rate stays
        this run's)."""
        step = int(state["step"])
        with torch.no_grad():
            for side, name, t in self._named():
                t.copy_(torch.from_numpy(np.asarray(state["params"][side][name])))
                if step:
                    self.opt.state[t] = {
                        "step": torch.tensor(float(step), dtype=torch.float32),
                        "exp_avg": torch.from_numpy(np.array(
                            state["exp_avg"][side][name])).to(self.device),
                        "exp_avg_sq": torch.from_numpy(np.array(
                            state["exp_avg_sq"][side][name])).to(self.device)}


def _stream_groups(pair_chunks: Callable, erng: np.random.Generator,
                   G: int, B: int):
    """The JAX package's streaming batches: fixed-size (G, B) step groups
    shuffled within each chunk, remainders carried across chunks, and
    the tail that cannot fill a group as (1, B) steps."""
    carry_u = np.zeros(0, np.int32)
    carry_i = np.zeros(0, np.int32)
    for chunk in pair_chunks():
        u_c = np.concatenate([carry_u, np.asarray(chunk[0], np.int32)])
        i_c = np.concatenate([carry_i, np.asarray(chunk[1], np.int32)])
        g = len(u_c) // (G * B)
        if g == 0:
            carry_u, carry_i = u_c, i_c
            continue
        cperm = erng.permutation(len(u_c))
        take, rest = cperm[: g * G * B], cperm[g * G * B:]
        carry_u, carry_i = u_c[rest], i_c[rest]
        ub = u_c[take].reshape(g, G, B)
        ib = i_c[take].reshape(g, G, B)
        for j in range(g):
            yield ub[j], ib[j]
    m = len(carry_u) // B
    if m:
        cperm = erng.permutation(len(carry_u))[: m * B]
        ub = carry_u[cperm].reshape(m, B)
        ib = carry_i[cperm].reshape(m, B)
        for j in range(m):
            yield ub[j:j + 1], ib[j:j + 1]


def two_tower_train(
    user_idx: np.ndarray, item_idx: np.ndarray,
    n_users: int, n_items: int,
    params: TwoTowerParams,
    pair_chunks: Optional[Callable] = None,
    device=None,
    initial_variables: Optional[Tuple[Dict, Dict]] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Train on positive (user, item) pairs on ``device`` (CUDA unless
    the caller names another); returns (user_variables, item_variables)
    as flax variable dicts of numpy arrays.

    ``pair_chunks`` (a zero-arg callable returning an iterator of
    (user_idx, item_idx, …) numpy chunks, e.g. ``InteractionData.chunks``)
    selects the STREAMING input path: each epoch re-streams the chunks
    through a :class:`~predictionio_tpu_torch.data.pipeline.DevicePrefetcher`
    and shuffles WITHIN chunks; ``user_idx``/``item_idx`` may then be
    empty and the pair count comes from ``params.n_pairs`` or one extra
    counting pass. ``initial_variables`` replaces the seeded init (the
    tests carry the JAX package's initial weights in). ``stats`` (a
    dict) receives ``epoch_losses`` (each run epoch's mean loss),
    ``steps`` and ``train_sec`` (the epochs' wall, synchronised)."""
    from predictionio_tpu_torch.utils.device import full_f32, resolve_device

    dev = resolve_device(device)
    p = params
    n = len(user_idx)
    if pair_chunks is not None and n == 0:
        if p.n_pairs:
            n = p.n_pairs  # caller already counted (vocabulary pass)
        else:
            n = sum(len(c[0]) for c in pair_chunks())
    if n < 2:
        raise ValueError("two-tower training needs at least 2 positive pairs "
                         "(in-batch negatives)")
    B = min(p.batch_size, n)
    n_batches = max(1, n // B)
    uv, iv = (initial_variables if initial_variables is not None
              else init_variables(n_users, n_items, p))
    tr = TwoTowerTrainer(uv, iv, p, dev)

    # mid-train checkpoint/resume: per-epoch RNG is seeded by epoch index
    # so a resumed run replays the exact batch permutations a straight
    # run would have used
    start_epoch = 0
    ckpt = None
    if p.checkpoint_dir:
        from predictionio_tpu_torch.utils.checkpoint import (
            CheckpointGeometryError,
            TrainCheckpointer,
        )

        ckpt = TrainCheckpointer(p.checkpoint_dir)
        if ckpt.latest_step() is not None:
            try:
                state, start_epoch = ckpt.restore_latest_compatible(tr.state())
                # THIS run's learning rate wins: the optimizer was built
                # with it, and only parameters, moments and the step
                # count are restored
                tr.load_state(state)
            except CheckpointGeometryError:
                # CONFIRMED stale (another tower geometry) → fresh start;
                # wipe so the stale latest step can't shadow this run's
                # saves. Transient read errors propagate.
                import warnings

                warnings.warn(
                    "two_tower checkpoints are stale (geometry/format change) — wiped; training restarts from scratch",
                    RuntimeWarning)
                ckpt.clear()

    epoch_losses: List[float] = []
    steps = 0
    t0 = time.perf_counter()
    with full_f32():
        for epoch in range(start_epoch, p.epochs):
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            epoch_steps = 0
            if pair_chunks is not None:
                from predictionio_tpu_torch.data.pipeline import DevicePrefetcher

                erng = np.random.default_rng(p.seed + epoch)
                # fixed-size (G, B) step groups: one transfer per G steps,
                # so the depth-2 prefetcher overlaps chunk decode with
                # the steps
                G = max(1, 65536 // B)
                with DevicePrefetcher(_stream_groups(pair_chunks, erng, G, B),
                                      device=dev) as pf:
                    for ue, ie in pf:
                        ue = torch.as_tensor(ue, device=dev).long()
                        ie = torch.as_tensor(ie, device=dev).long()
                        for j in range(ue.shape[0]):
                            loss_sum += tr.step(ue[j], ie[j])
                        epoch_steps += int(ue.shape[0])
                if epoch_steps == 0:
                    raise ValueError(
                        f"streaming train performed zero steps: {n} pairs "
                        f"never filled one batch of {B}; lower batch_size")
            else:
                perm = np.random.default_rng(p.seed + epoch).permutation(n)[: n_batches * B]
                ue = torch.from_numpy(user_idx[perm].reshape(n_batches, B)
                                      .astype(np.int64)).to(dev)
                ie = torch.from_numpy(item_idx[perm].reshape(n_batches, B)
                                      .astype(np.int64)).to(dev)
                for j in range(n_batches):
                    loss_sum += tr.step(ue[j], ie[j])
                epoch_steps = n_batches
            epoch_losses.append(float(loss_sum) / epoch_steps)
            steps += epoch_steps
            if ckpt is not None and (epoch + 1) % max(1, p.checkpoint_every) == 0:
                ckpt.save(epoch + 1, tr.state())
    if stats is not None:
        stats.update(epoch_losses=epoch_losses, steps=steps,
                     train_sec=time.perf_counter() - t0)
    if ckpt is not None:
        ckpt.close()
    return tr.variables()


# -- serving ------------------------------------------------------------------


def _tower_forward_np(variables, ids: np.ndarray) -> np.ndarray:
    """Numpy replay of the tower forward pass (Embed → Dense+relu… → Dense
    → L2 normalize), the JAX package's: a per-query tower pass is a
    handful of tiny GEMVs, and the tables it fills are what the device
    scorers hold."""
    p = variables["params"]
    x = np.asarray(p["Embed_0"]["embedding"])[ids]
    dense_names = sorted((k for k in p if k.startswith("Dense_")),
                         key=lambda k: int(k.split("_")[1]))
    for j, name in enumerate(dense_names):
        x = x @ np.asarray(p[name]["kernel"]) + np.asarray(p[name]["bias"])
        if j < len(dense_names) - 1:
            x = np.maximum(x, 0.0)
    return x / (1e-8 + np.linalg.norm(x, axis=-1, keepdims=True))


def two_tower_embed_items(item_variables, n_items: int,
                          params: TwoTowerParams) -> np.ndarray:
    """Precompute the full item-embedding table for serving."""
    return _tower_forward_np(item_variables, np.arange(n_items))


def two_tower_user_embed(user_variables, user_id: int, n_users: int,
                         params: TwoTowerParams) -> np.ndarray:
    return _tower_forward_np(user_variables, np.asarray([user_id]))[0]


def two_tower_embed_users(user_variables, n_users: int,
                          params: TwoTowerParams,
                          chunk: int = 65536) -> np.ndarray:
    """Precompute every user's embedding, in chunks so the intermediate
    activations stay bounded. With both tables materialized, two-tower
    serving rides the ALS family's device scorers — one dispatch per
    (micro-)batch."""
    return np.concatenate([
        _tower_forward_np(user_variables, np.arange(lo, min(lo + chunk,
                                                            n_users)))
        for lo in range(0, n_users, chunk)])


def two_tower_build_index(item_embeds: np.ndarray, m: int = 8, k: int = 256,
                          *, iters: int = 8, seed: int = 0,
                          sample: int = 65536, opq: bool = False,
                          opq_iters: int = 4, shards: int = 0, device=None):
    """Build the PQ retrieval index over the materialized item table on
    ``device`` — the ``pio train``-time step that turns exact top-k
    serving into ADC-shortlist + re-rank. Returns a
    :class:`predictionio_tpu_torch.ann.PQIndex`. ``opq=True`` trains an
    OPQ-style rotation first (versioned into the blob); ``shards > 1``
    records a serving-mesh hint, which the port's scorer refuses."""
    from predictionio_tpu_torch.ann.index import build_index

    return build_index(np.asarray(item_embeds, np.float32), m, k,
                       iters=iters, seed=seed, sample=sample,
                       opq=opq, opq_iters=opq_iters,
                       shards=(int(shards) if shards
                               and int(shards) > 1 else None),
                       device=device)
