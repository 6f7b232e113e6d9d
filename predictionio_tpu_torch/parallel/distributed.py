"""Multi-process runtime: rendezvous, barriers, broadcasts and gathers.

The port's counterpart of the JAX package's ``parallel/distributed.py``.
Every process of a run calls the same entry point in lockstep; this module
is the shell around ``torch.distributed``: initialization from the
environment, the process's own device slots against every process's, and
the few collectives the workflow and the sharded trainer need. The
backend follows the device: NCCL for CUDA, gloo for the CPU.

Without the ``PIO_*`` rendezvous variables nothing is initialized and
every helper degrades to the one-process case.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

_initialized = False
#: this process's slots when ``initialize`` was given them
_local: Optional[List[torch.device]] = None
#: every process's slots, in process order (gathered once a platform)
_global: dict = {}


@dataclass
class DistributedConfig:
    """Rendezvous parameters, usually from the environment:
    ``PIO_COORDINATOR_ADDRESS`` (host:port of process 0),
    ``PIO_NUM_PROCESSES`` and ``PIO_PROCESS_ID``."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        e = os.environ

        def num(k: str) -> Optional[int]:
            return int(e[k]) if k in e else None

        return cls(
            coordinator_address=e.get("PIO_COORDINATOR_ADDRESS"),
            num_processes=num("PIO_NUM_PROCESSES"),
            process_id=num("PIO_PROCESS_ID"),
        )

    @property
    def requested(self) -> bool:
        return self.coordinator_address is not None


def initialize(config: Optional[DistributedConfig] = None, device=None,
               slots: Optional[Sequence[Any]] = None) -> bool:
    """``torch.distributed.init_process_group`` over
    ``tcp://PIO_COORDINATOR_ADDRESS`` when the rendezvous variables are
    set, otherwise a no-op. Idempotent. Returns True when running
    multi-process.

    ``slots`` fixes this process's slots (a device may be named
    more than once); by default they are :func:`mesh.platform_devices` of
    ``device``'s type. The backend follows the slots: NCCL for CUDA,
    gloo for the CPU."""
    global _initialized, _local
    import torch.distributed as dist

    config = config or DistributedConfig.from_env()
    if _initialized:
        return process_count() > 1
    if slots is not None:
        _local = [torch.device(d) for d in slots]
    if config.requested:
        if config.num_processes is None or config.process_id is None:
            raise ValueError("PIO_COORDINATOR_ADDRESS needs PIO_NUM_PROCESSES "
                             "and PIO_PROCESS_ID")
        platform = None if device is None else torch.device(device).type
        first = local_devices(platform)[0]
        if first.type == "cuda":
            torch.cuda.set_device(first)
        dist.init_process_group(
            "nccl" if first.type == "cuda" else "gloo",
            init_method=f"tcp://{config.coordinator_address}",
            world_size=int(config.num_processes), rank=int(config.process_id))
        _initialized = True
    return process_count() > 1


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _initialized, _local
    import torch.distributed as dist

    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _local = False, None
    _global.clear()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def local_devices(platform: Optional[str] = None) -> List[torch.device]:
    """Slots of THIS process: those ``initialize`` was given, else
    :func:`mesh.platform_devices` of ``platform``."""
    if _local is not None:
        return list(_local)
    from predictionio_tpu_torch.parallel.mesh import platform_devices

    return platform_devices(platform)


def global_slots(platform: Optional[str] = None
                 ) -> Tuple[List[torch.device], List[int]]:
    """Every process's slots in process order, and the owner of each."""
    local = local_devices(platform)
    if process_count() <= 1:
        return local, [0] * len(local)
    key = (platform, tuple(str(d) for d in local))
    if key not in _global:
        import torch.distributed as dist

        parts: List[Any] = [None] * process_count()
        dist.all_gather_object(parts, [str(d) for d in local])
        devs = [torch.device(d) for part in parts for d in part]
        owners = [p for p, part in enumerate(parts) for _ in part]
        _global[key] = (devs, owners)
    devs, owners = _global[key]
    return list(devs), list(owners)


def global_devices(platform: Optional[str] = None) -> List[torch.device]:
    return global_slots(platform)[0]


def barrier(name: str = "pio_barrier") -> None:
    """Cross-process sync point (a no-op in one process). ``name`` says
    which point of the workflow it is; torch's barrier is anonymous."""
    import torch.distributed as dist

    if process_count() <= 1:
        return
    dist.barrier()


def broadcast_from_coordinator(tree):
    """Process 0's value of a picklable host value (numpy arrays, nested
    tuples, lists and dicts of them) on every process."""
    import torch.distributed as dist

    if process_count() <= 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_string(s: str, max_len: int = 256) -> str:
    """Broadcast a short string (e.g. the engine-instance id minted by
    the coordinator) to every process."""
    if process_count() <= 1:
        return s
    buf = np.zeros(max_len, np.uint8)
    raw = s.encode()
    if len(raw) > max_len:
        raise ValueError(f"string longer than {max_len} bytes")
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.asarray(broadcast_from_coordinator(buf))
    return bytes(out).rstrip(b"\x00").decode()


def all_gather_parts(part: torch.Tensor) -> torch.Tensor:
    """Every process's ``part`` (equal shapes) concatenated along dim 0 in
    process order, on ``part``'s device (which the backend must take:
    the CPU for gloo, this process's card for NCCL)."""
    import torch.distributed as dist

    if process_count() <= 1:
        return part
    part = part.contiguous()
    out = torch.empty((process_count() * part.shape[0],) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    with warnings.catch_warnings():
        # newer torch names it all_gather_single; the call is the same
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, part)
    return out
