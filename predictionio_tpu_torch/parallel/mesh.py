"""Device mesh: an array of device slots with axis names.

The port's counterpart of the JAX package's ``parallel/mesh.py``: an
engine.json ``meshConf`` block (``{"mesh": {"data": 4}, "allowSmaller":
true}``) resolves here into a :class:`Mesh`, with the JAX package's rules
for an empty config (every available device on ``"data"``) and for a
config asking for more devices than there are (clamp the largest axis, or
raise). The axes keep the JAX package's meanings: ``"data"`` splits
ratings and batches (sharded ALS), ``"model"`` parameters, ``"shards"``
the rows of a sweep's grid and the item rows of sharded ANN serving.

A slot is a ``torch.device``, and one device may fill several slots: the
CPU tests run eight shards on one CPU, as the JAX tests run them on eight
virtual CPU devices, and one card can hold four shards. Without a
``devices`` argument the slots are the devices of every process of the
run (``parallel/distributed.global_devices``) in process order: the
cards of each process, or one CPU where ``PIO_MESH_PLATFORM=cpu`` or the
entry point was asked for the CPU. ``Mesh.processes`` records which
process owns each slot; a process computes only on its own slots.

The JAX package's shard_map helpers (``get_shard_map``, ``has_vma``,
``shard_map_unchecked``, ``pvary``, ``replicated``, ``shard_batch``) have
no counterpart: the port's sharded paths are plain loops over the local
slots with explicit gathers. Each JAX collective becomes one explicit
step: ``all_gather`` and ``psum`` a copy onto the gathering slot, then a
``cat`` or a sum in slot order; ``ppermute`` a copy to the next slot;
``all_to_all`` per-slot slicing and copies. Sharded ALS exchanges factor
blocks between processes too; the serving and attention paths (sharded
ANN, data-parallel training, ring and Ulysses attention) run over the
slots of one process, as the JAX package's ``device_put`` onto a
``NamedSharding`` needs every slot addressable (:func:`process_slots`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

@dataclass
class MeshConfig:
    """Parsed ``meshConf`` block of engine.json.

    ``{"mesh": {"data": 8}}`` → 1-D 8-way data parallel;
    ``{"mesh": {"data": 4, "model": 2}}`` → 2-D. Empty → every available
    device on the ``data`` axis."""

    axes: Dict[str, int] = field(default_factory=dict)
    #: allow fewer devices than requested (clamp the largest axis)
    allow_smaller: bool = True

    @classmethod
    def from_json(cls, obj: Optional[Dict[str, Any]]) -> "MeshConfig":
        obj = obj or {}
        axes = {str(k): int(v) for k, v in (obj.get("mesh") or {}).items()}
        return cls(axes=axes, allow_smaller=bool(obj.get("allowSmaller", True)))


class Mesh:
    """Slots (``torch.device``) in an array of shape ``axis sizes``, the
    axis names, and the process owning each slot."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (np.zeros(devices.shape, np.int64) if processes is None
                          else np.asarray(processes, np.int64).reshape(devices.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> List[torch.device]:
        """Every slot, in row-major order."""
        return list(self.devices.flat)

    def local_slots(self) -> List[int]:
        """Indices (row-major) of the slots this process owns."""
        from predictionio_tpu_torch.parallel.distributed import process_index

        me = process_index()
        return [i for i, p in enumerate(self.processes.flat) if p == me]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, slots={[str(d) for d in self.slots]}, "
                f"processes={self.processes.ravel().tolist()})")


def platform_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The devices of this process on ``platform`` (``PIO_MESH_PLATFORM``
    when None, else ``cuda``): every visible card, or one CPU. Asking for
    cards where there is none raises, as every entry point of the port
    does."""
    from predictionio_tpu_torch.utils.device import resolve_device

    platform = platform or os.environ.get("PIO_MESH_PLATFORM") or "cuda"
    if platform == "cpu":
        return [torch.device("cpu")]
    if platform in ("cuda", "gpu"):
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    raise ValueError(f"unsupported mesh platform {platform!r}")


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence[Any]] = None,
              platform: Optional[str] = None) -> Mesh:
    """Build a mesh per ``config`` over ``devices`` (this process's
    slots), or, when None, over every process's devices on ``platform``
    (see :func:`platform_devices`). A config asking for more slots than
    there are clamps its largest axis when ``allow_smaller`` holds and
    otherwise raises ``"mesh needs N devices, have M"``."""
    from predictionio_tpu_torch.parallel import distributed

    if devices is None:
        devs, procs = distributed.global_slots(platform)
    else:
        devs = [torch.device(d) for d in devices]
        procs = [distributed.process_index()] * len(devs)
    config = config or MeshConfig()
    axes = dict(config.axes)
    if not axes:
        axes = {"data": len(devs)}
    want = int(np.prod(list(axes.values())))
    if want > len(devs):
        if not config.allow_smaller:
            raise ValueError(f"mesh needs {want} devices, have {len(devs)}")
        # clamp the largest axis down to what's available
        biggest = max(axes, key=lambda k: axes[k])
        other = want // axes[biggest]
        axes[biggest] = max(1, len(devs) // other)
        want = int(np.prod(list(axes.values())))
    grid = np.empty(want, dtype=object)
    for i, d in enumerate(devs[:want]):
        grid[i] = d
    shape = tuple(axes.values())
    return Mesh(grid.reshape(shape), tuple(axes.keys()),
                np.asarray(procs[:want], np.int64).reshape(shape))


def shards_mesh(shards: int, devices: Optional[Sequence[Any]] = None,
                platform: Optional[str] = None) -> Mesh:
    """1-D mesh over the ``shards`` axis. Never clamps: raises when fewer
    than ``shards`` slots are available (callers that can degrade choose
    to, this helper never does)."""
    return make_mesh(MeshConfig(axes={"shards": int(shards)},
                                allow_smaller=False), devices, platform)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def device_count(platform: Optional[str] = None) -> int:
    """Slots of every process on ``platform``."""
    from predictionio_tpu_torch.parallel import distributed

    return len(distributed.global_devices(platform))


def process_slots(mesh: Mesh, what: str, axis: Optional[str] = None
                  ) -> List[torch.device]:
    """The slots a one-process sharded path runs over, in order: every
    slot of ``mesh``, or with ``axis`` the slots along that axis (the
    other axes at their first index). Raises when a slot of the mesh
    belongs to another process: these paths gather onto this process's
    slots, as the JAX package needs every device addressable."""
    owners = sorted(set(int(p) for p in mesh.processes.flat))
    if len(owners) > 1:
        raise ValueError(f"{what} runs over the slots of one process; this mesh "
                         f"spans processes {owners}")
    if axis is None:
        return mesh.slots
    at = [0] * mesh.devices.ndim
    at[mesh.axis_names.index(axis)] = slice(None)
    return list(mesh.devices[tuple(at)])
