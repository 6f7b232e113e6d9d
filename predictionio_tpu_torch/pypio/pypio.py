"""Session-level helpers: bind storage, read events, hand models over
(the reference's ``pypio.init()/find_events()/save_model()``)."""

from __future__ import annotations

import pickle
from typing import Any, Optional

_storage = None


def init(storage: Optional[Any] = None) -> None:
    """Bind the bridge to ``storage`` (default: the PIO_* env config)."""
    global _storage
    from predictionio_tpu_torch.storage.registry import get_storage

    _storage = storage if storage is not None else get_storage()


def _st():
    if _storage is None:
        init()
    return _storage


def stop() -> None:
    """Release the bridge binding."""
    global _storage
    _storage = None


def find_events(app_name: str, **kwargs):
    """Events as a pandas DataFrame; kwargs as PEventStore.find."""
    from predictionio_tpu_torch.pypio.data import PEventStore

    return PEventStore.find(app_name, **kwargs)


def save_model(model: Any, engine_instance_id: str,
               algorithm: str = "default") -> None:
    """Persist a Python model blob under an engine instance. Other
    algorithms already saved under the same instance are preserved.

    Notebook models use a ``{algorithm: model}`` dict blob; instances
    trained by ``pio train`` store a per-algorithm list managed by the
    workflow — refuse to clobber those."""
    st = _st()
    blob = st.models.get(engine_instance_id)
    d = pickle.loads(blob) if blob else {}
    if not isinstance(d, dict):
        raise ValueError(
            f"engine instance {engine_instance_id!r} was trained by the "
            "workflow (`pio train`); its models belong to prepare_deploy. "
            "Save notebook models under a fresh instance id.")
    d[algorithm] = model
    st.models.put(engine_instance_id, pickle.dumps(d))


def load_model(engine_instance_id: str, algorithm: str = "default") -> Any:
    blob = _st().models.get(engine_instance_id)
    if blob is None:
        raise KeyError(f"no model for engine instance {engine_instance_id}")
    d = pickle.loads(blob)
    if not isinstance(d, dict):
        raise ValueError(
            f"engine instance {engine_instance_id!r} was trained by the "
            "workflow (`pio train`); load it with "
            "predictionio_tpu_torch.core.workflow.prepare_deploy instead.")
    return d[algorithm]
