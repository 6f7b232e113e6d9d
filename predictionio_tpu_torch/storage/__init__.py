"""Storage the port's training and deploy read: apps, engine-instance
records, events and model blobs, on the JAX package's on-disk layout."""

from predictionio_tpu_torch.storage.meta import EngineInstance, MetaStore
from predictionio_tpu_torch.storage.models import (
    LocalFSModelStore,
    MemoryModelStore,
    ModelStore,
)
from predictionio_tpu_torch.storage.registry import (
    Storage,
    StorageConfig,
    get_storage,
    set_storage,
)

__all__ = [
    "EngineInstance", "MetaStore", "ModelStore", "LocalFSModelStore",
    "MemoryModelStore", "Storage", "StorageConfig", "get_storage",
    "set_storage",
]
