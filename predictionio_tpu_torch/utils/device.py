"""Device resolution and the device rules shared by every entry point of
the port."""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Union

import torch

#: why a mesh of more than one device is refused: the port has none yet
MESH_NOT_PORTED = (
    "a device mesh of more than one device is not ported to "
    "predictionio_tpu_torch yet (ROADMAP.md queue 1, item 8)")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` when the caller names
    none, else the caller's. Raises when that is a CUDA device and no
    card is present; it never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_mesh(mesh_conf: Optional[Dict[str, Any]]) -> None:
    """Refuse an engine.json ``meshConf`` block whose ``mesh`` axes
    (``{"mesh": {"data": 8}}``) ask for more than one device."""
    want = 1
    for size in ((mesh_conf or {}).get("mesh") or {}).values():
        want *= int(size)
    if want > 1:
        raise ValueError(f"meshConf {mesh_conf} asks for {want} devices: "
                         f"{MESH_NOT_PORTED}")


@contextlib.contextmanager
def full_f32():
    """f32 matrix products at full precision (no TF32) for the duration:
    normal equations, Gram sums and losses must not lose ten mantissa
    bits."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
