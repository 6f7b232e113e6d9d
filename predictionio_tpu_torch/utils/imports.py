"""Spec-string resolution: ``"module.path:attr"`` → object.

The port's copy of the JAX package's ``utils/imports.py``: the Python
replacement for the reference's reflective class loading, shared by the
CLI (``eval``'s evaluation and generator specs) and the plugin loader
(``PIO_PLUGINS``) so that their error behaviour stays uniform.
"""

from __future__ import annotations

import importlib
from typing import Any


def resolve_spec(spec: str) -> Any:
    if ":" in spec:
        mod_name, attr = spec.split(":", 1)
    else:
        mod_name, _, attr = spec.rpartition(".")
    if not mod_name or not attr:
        raise ImportError(f"bad spec {spec!r}; expected 'module.path:attr'")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError as e:
        raise ImportError(f"{mod_name!r} has no attribute {attr!r}") from e
