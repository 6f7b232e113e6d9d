"""Storage the port's training, deploy and evaluation read: apps,
engine- and evaluation-instance records, events, model blobs and sweep
leaderboards, on the JAX package's on-disk layout."""

from predictionio_tpu_torch.storage.meta import (
    EngineInstance,
    EvaluationInstance,
    MetaStore,
)
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
    "EngineInstance", "EvaluationInstance", "MetaStore", "ModelStore", "LocalFSModelStore",
    "MemoryModelStore", "Storage", "StorageConfig", "get_storage",
    "set_storage",
]
