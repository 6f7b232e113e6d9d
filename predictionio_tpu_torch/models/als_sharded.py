"""Sharded ALS: the bucketed half-step over the slots of a device mesh.

The port's counterpart of the JAX package's ``models/als_sharded.py``,
running the SAME half-step as the single-device trainer
(:func:`predictionio_tpu_torch.models.als._make_half`: one ``gather_gram``
launch a bucket, one ``chol_solve`` launch a part) on each shard:

- Users (and items) are range-partitioned into ``n_dev`` equal blocks;
  each slot owns one block of U rows and one of V rows, kept in
  count-descending PERMUTED order for the whole run (un-permuted once on
  the host at the end).
- Each slot's rating rows are laid out in the bucketed format of
  :mod:`predictionio_tpu_torch.models.als` with bucket boundaries
  MAX-MERGED across shards (``als._merge_bounds``), so every shard has one
  geometry. Other-side indices are pre-mapped on the host to the
  counterpart's permuted GLOBAL positions, so the gathered factor matrix
  is indexed directly: partitioning happens once, at layout time. The
  layout is bitwise the JAX package's, shard by shard.
- Each half-step gathers the counterpart factor blocks over ``"data"``:
  the local slots' blocks are concatenated onto each slot's device and,
  when the mesh spans processes, each process's part is exchanged with
  ``torch.distributed.all_gather_into_tensor``. Then each local shard
  solves its own block on its own device.

Every process ends with the whole (U, V), as the JAX package's
``process_allgather`` gives it.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.models.als import (
    ALSParams,
    RatingsCOO,
    _bucket_side,
    _BucketSide,
    _make_half,
    _merge_bounds,
    _perm_by_count_desc,
    _side_buffers,
    init_factors,
)
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.utils.device import full_f32, resolve_device


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@dataclass
class ALSShardedPrepared:
    """Per-shard bucketed layouts with common (max-merged) geometry."""

    n_users: int
    n_items: int
    nnz: int
    n_dev: int
    block_u: int
    block_i: int
    u_sides: List[_BucketSide]  # one per shard, identical geometry
    i_sides: List[_BucketSide]
    _device_bufs: Optional[dict] = None  # (shard, device) -> both sides' buffers

    @property
    def geom_u(self):
        return self.u_sides[0].geometry

    @property
    def geom_i(self):
        return self.i_sides[0].geometry

    def device_buffers(self, shard: int, device: torch.device) -> tuple:
        """One shard's layout on ``device``, cached per (shard, device):
        a reused layout (a ``pio eval`` grid) uploads once."""
        if self._device_bufs is None:
            self._device_bufs = {}
        key = (shard, device)
        if key not in self._device_bufs:
            self._device_bufs[key] = (_side_buffers(self.u_sides[shard], device),
                                      _side_buffers(self.i_sides[shard], device))
        return self._device_bufs[key]


def _device_perms(idx, block, n_dev):
    """Per-shard local counts and count-desc permutations, plus the map
    from ORIGINAL global entity id → permuted global position
    (owner_block_start + inv_perm_owner[local_id]). Computed ONCE per
    side: the layout builder and the other side's index mapping must
    agree on these permutations exactly."""
    counts = np.bincount(idx, minlength=block * n_dev).astype(np.int64)
    locs, perms, invs = [], [], []
    pos = np.empty(block * n_dev, np.int32)
    for d in range(n_dev):
        c = counts[d * block:(d + 1) * block]
        perm, inv = _perm_by_count_desc(c.astype(np.float32))
        locs.append(c)
        perms.append(perm)
        invs.append(inv)
        pos[d * block:(d + 1) * block] = d * block + inv
    return locs, perms, invs, pos


def _side_prepared(idx_self, idx_other, vals, block, n_dev,
                   locs, perms, invs, other_pos, n_other):
    """Every shard's bucketed layout for one orientation. ``other_pos[j]``
    maps an ORIGINAL other-entity id to its permuted global position in
    the gathered factor matrix; ``n_other`` is that matrix's height
    (padded global size)."""
    owner = idx_self // block
    bounds = _merge_bounds([locs[d][perms[d]] for d in range(n_dev)], n_other)
    sides = []
    for d in range(n_dev):
        sel = owner == d
        sides.append(_bucket_side(
            (idx_self[sel] - d * block).astype(np.int32),
            other_pos[idx_other[sel]].astype(np.int32),
            vals[sel].astype(np.float32),
            block, locs[d].astype(np.float32), perms[d], invs[d],
            n_other=n_other, bounds=bounds))
    geom = sides[0].geometry
    assert all(s.geometry == geom for s in sides), \
        "max-merged bounds must give every shard the same geometry"
    return sides


def als_prepare_sharded(coo: RatingsCOO, n_dev: int) -> ALSShardedPrepared:
    """Host-side layout of the sharded path (done once per dataset)."""
    block_u = -(-coo.n_users // n_dev)  # ceil
    block_i = -(-coo.n_items // n_dev)

    ulocs, uperms, uinvs, upos = _device_perms(coo.user_idx, block_u, n_dev)
    ilocs, iperms, iinvs, ipos = _device_perms(coo.item_idx, block_i, n_dev)

    u_sides = _side_prepared(coo.user_idx, coo.item_idx, coo.rating,
                             block_u, n_dev, ulocs, uperms, uinvs, ipos,
                             n_other=block_i * n_dev)
    i_sides = _side_prepared(coo.item_idx, coo.user_idx, coo.rating,
                             block_i, n_dev, ilocs, iperms, iinvs, upos,
                             n_other=block_u * n_dev)
    return ALSShardedPrepared(coo.n_users, coo.n_items, coo.nnz, n_dev,
                              block_u, block_i, u_sides, i_sides)


class _Shards:
    """This process's shards of a mesh and the gather over ``"data"``."""

    def __init__(self, mesh, n_dev: int) -> None:
        slots = mesh.slots
        self.local = mesh.local_slots()
        self.devices = {d: resolve_device(slots[d]) for d in self.local}
        owners = list(mesh.processes.flat)
        self.spans = len(set(owners)) > 1
        if self.spans and (owners != sorted(owners) or len(self.local) * len(
                set(owners)) != n_dev):
            raise ValueError("a mesh over several processes needs an equal, "
                             "process-ordered share of slots in each: "
                             f"{owners}")
        # the device the exchange between processes runs on: the CPU for
        # gloo, this process's (first) card for NCCL
        self.comm = self.devices[self.local[0]]

    def gather(self, blocks: Dict[int, torch.Tensor]) -> Dict[torch.device, torch.Tensor]:
        """The full factor matrix (every shard's block in shard order) on
        each device of this process's slots."""
        part = torch.cat([blocks[d].to(self.comm) for d in self.local])
        full = distributed.all_gather_parts(part) if self.spans else part
        return {dev: full.to(dev) for dev in set(self.devices.values())}

    def fetch(self, blocks: Dict[int, torch.Tensor]) -> np.ndarray:
        return self.gather(blocks)[self.comm].cpu().numpy()


def als_train_sharded_prepared(
    prep: ALSShardedPrepared, p: ALSParams, mesh,
    checkpointer=None, checkpoint_every: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train over the mesh; returns full (U, V) in original order.

    With ``checkpointer`` + ``checkpoint_every > 0`` the iterations run in
    blocks of ``checkpoint_every``, and after each block the (permuted,
    sharded-layout) factors are saved. Exact by construction: V fully
    determines the next iteration, so resuming from a block boundary
    reproduces the uninterrupted run. A restart restores the newest
    compatible step; a checkpoint of another rank or shard count (stale
    geometry) is wiped with a RuntimeWarning and training starts over. In
    a multi-process run the coordinator reads and writes the checkpoints,
    broadcasts what it restored, and the others wait at a barrier."""
    n_dev = prep.n_dev
    block_u, block_i = prep.block_u, prep.block_i
    if mesh.size != n_dev:
        raise ValueError(
            f"layout was prepared for {n_dev} devices but the mesh has "
            f"{mesh.size}")
    shards = _Shards(mesh, n_dev)
    bufs = {d: prep.device_buffers(d, dev) for d, dev in shards.devices.items()}
    half = _make_half(p.rank, bool(p.implicit), bool(p.weighted_reg),
                      bool(p.bf16_gather))
    # the reference passes reg and alpha as f32 scalars
    reg, alpha = float(np.float32(p.reg)), float(np.float32(p.alpha))

    # identical init to the single-device path, per-shard permuted so the
    # resident factor order matches the bucketed layouts
    V0g = _pad_rows(init_factors(prep.n_items, p.rank, p.seed), block_i * n_dev)
    V0p = np.concatenate([
        V0g[d * block_i:(d + 1) * block_i][prep.i_sides[d].perm]
        for d in range(n_dev)])

    def blocks_of(xp: np.ndarray, block: int) -> Dict[int, torch.Tensor]:
        return {d: torch.as_tensor(np.ascontiguousarray(
                    xp[d * block:(d + 1) * block])).to(dev)
                for d, dev in shards.devices.items()}

    def solve(F_full, sides, side_bufs):
        return {d: half(F_full[dev], sides[d], side_bufs(d), reg, alpha)
                for d, dev in shards.devices.items()}

    def run(V: Dict[int, torch.Tensor], n_iters: int):
        if n_iters == 0:
            # the single-device contract for iterations == 0: U solved
            # from the initial V
            return solve(shards.gather(V), prep.u_sides, lambda d: bufs[d][0]), V
        for _ in range(n_iters):
            U = solve(shards.gather(V), prep.u_sides, lambda d: bufs[d][0])
            V = solve(shards.gather(U), prep.i_sides, lambda d: bufs[d][1])
        return U, V

    # -- resume: the coordinator reads, every process gets what it read ------
    start, U_done = 0, None
    if checkpointer is not None:
        restored = None
        if distributed.is_coordinator() and checkpointer.latest_step() is not None:
            from predictionio_tpu_torch.utils.checkpoint import CheckpointGeometryError

            template = {"U": np.zeros((block_u * n_dev, p.rank), np.float32),
                        "V": np.zeros_like(V0p)}
            try:
                state, step = checkpointer.restore_latest_compatible(template)
                restored = (np.asarray(state["U"]), np.asarray(state["V"]), int(step))
            except CheckpointGeometryError:
                warnings.warn(
                    "sharded ALS checkpoints are stale (geometry/layout "
                    "change) — wiped; training restarts from scratch",
                    RuntimeWarning)
                checkpointer.clear()
        restored = distributed.broadcast_from_coordinator(restored)
        if restored is not None:
            U_done, V0p, step = restored
            start = min(step, p.iterations)

    with full_f32():
        if start >= p.iterations and U_done is not None:
            # died between the final checkpoint and model persistence
            Uh, Vh = U_done, V0p
        elif checkpointer is None or checkpoint_every <= 0 or p.iterations == 0:
            U, V = run(blocks_of(V0p, block_i), p.iterations - start)
            Uh, Vh = shards.fetch(U), shards.fetch(V)
        else:
            V, it = blocks_of(V0p, block_i), start
            while it < p.iterations:
                n = min(checkpoint_every, p.iterations - it)
                U, V = run(V, n)
                it += n
                Uh, Vh = shards.fetch(U), shards.fetch(V)
                if distributed.is_coordinator():
                    checkpointer.save(it, {"U": Uh, "V": Vh})
                distributed.barrier("pio_als_checkpoint")

    def unpermute(xp, sides, block, n):
        return np.concatenate([xp[d * block:(d + 1) * block][sides[d].inv_perm]
                               for d in range(n_dev)])[:n]

    return (unpermute(Uh, prep.u_sides, block_u, prep.n_users),
            unpermute(Vh, prep.i_sides, block_i, prep.n_items))


def als_train_sharded(
    coo: RatingsCOO, p: ALSParams, mesh,
    checkpointer=None, checkpoint_every: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train ALS over the mesh's ``data`` axis; returns full (U, V)."""
    if "data" not in mesh.axis_names:
        raise ValueError(f"mesh must have a 'data' axis, got {mesh.axis_names}")
    return als_train_sharded_prepared(als_prepare_sharded(coo, mesh.size), p, mesh,
                                      checkpointer=checkpointer,
                                      checkpoint_every=checkpoint_every)
