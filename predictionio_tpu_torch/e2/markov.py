"""First-order Markov chain over an integer state space.

The port of the JAX package's ``e2/markov.py`` (reference: e2's
MarkovChain — row-normalised transition probabilities from a count
matrix, and "top-K most likely next states"). Transition counting is a
segment sum over the flattened (from, to) pairs
(``ops.segment.segment_sum``) on the device (CUDA unless the caller asks
for the CPU), and the row normalisation runs there too; the model keeps
the dense (S, S) matrix on the host, where ``predict_top_k`` answers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.segment import segment_sum
from predictionio_tpu_torch.utils.device import resolve_device

#: the largest state space: S·S must fit int32 (the JAX package's x32
#: mode), and a dense (S, S) f32 matrix past it is over 8 GB anyway
MAX_STATES = 46_340


@dataclass
class MarkovChainModel:
    """Row-stochastic transition matrix (rows with no observations are
    all-zero, matching the reference's sparse behavior)."""

    transitions: np.ndarray  # (S, S) float32
    n_states: int

    def transition_prob(self, from_state: int, to_state: int) -> float:
        return float(self.transitions[from_state, to_state])

    def predict_top_k(self, from_state: int, k: int) -> List[Tuple[int, float]]:
        """Top-K next states by probability, ties in state order (host
        numpy: one (S,) row's top-k is µs work)."""
        row = self.transitions[from_state]
        k = min(k, self.n_states)
        idx = np.argpartition(-row, k - 1)[:k]
        idx = idx[np.argsort(-row[idx], kind="stable")]
        return [(int(i), float(row[i])) for i in idx if row[i] > 0.0]


def transition_counts(pairs: Sequence[Tuple[int, int]], n_states: int,
                      device=None) -> torch.Tensor:
    """(S, S) f32 transition counts on ``device``, after the JAX
    package's checks of the state space and of every id."""
    if n_states <= 0:
        raise ValueError("n_states must be positive")
    if n_states > MAX_STATES:
        # shard or sparsify externally for larger state spaces
        raise ValueError(
            f"n_states={n_states} too large for the dense transition "
            f"matrix (max {MAX_STATES})")
    dev = resolve_device(device)
    arr = np.asarray(pairs, np.int32).reshape(-1, 2)
    if arr.size and (arr.min() < 0 or arr.max() >= n_states):
        raise ValueError("state id out of range")
    pairs_d = torch.as_tensor(arr).to(dev).long()
    flat = pairs_d[:, 0] * n_states + pairs_d[:, 1]
    ones = torch.ones(flat.shape, dtype=torch.float32, device=dev)
    return segment_sum(ones, flat, n_states * n_states).view(n_states, n_states)


def markov_chain_train(pairs: Sequence[Tuple[int, int]], n_states: int,
                       device=None) -> MarkovChainModel:
    """Count (from, to) transitions and row-normalise, on ``device``."""
    counts = transition_counts(pairs, n_states, device)
    # in place: a row with no observations is all zeros, and 0 / 1 keeps
    # it so, as the JAX package's where(row_tot > 0, ..., 0) does
    probs = counts.div_(counts.sum(1, keepdim=True).clamp_(min=1.0))
    return MarkovChainModel(probs.cpu().numpy(), n_states)
