"""Template blobs pickled under the JAX package's class names.

A template's model blob pickles classes of the JAX package: a params
dataclass inside a dict, or the model object itself. The JAX package
pickles them under its own module paths, so a blob either package writes
names the JAX classes. The port writes its own classes under those names
without importing the JAX package, and maps the names back to its classes
on load, so blobs load in both directions. Any other name of the JAX
package is refused: loading it would import JAX.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Tuple

#: the port's class → the JAX package's (module, qualified name) of it
Names = Dict[type, Tuple[str, str]]


def dumps(obj: Any, names: Names) -> bytes:
    """Pickle ``obj`` as the JAX package's ``pickle.dumps`` does, with each
    class of ``names`` named by its JAX (module, qualified name)."""

    class _Pickler(pickle._Pickler):
        # the stock pickler checks a global by importing its module;
        # this one writes the module and name strings for the mapped
        # classes (the pure-Python pickler's ``save_global`` is the hook)
        def save_global(self, obj, name=None):
            jax_global = names.get(obj) if isinstance(obj, type) else None
            if jax_global is None:
                return super().save_global(obj, name)
            module, qualname = jax_global
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)

    buf = io.BytesIO()
    _Pickler(buf, max(pickle.DEFAULT_PROTOCOL, 4)).dump(obj)
    return buf.getvalue()


def loads(blob: bytes, names: Names, what: str) -> Any:
    """Unpickle ``blob`` with each JAX global of ``names`` mapped to its
    port class; any other name of the JAX package raises
    ``UnpicklingError`` naming ``what``."""
    classes = {jax_global: cls for cls, jax_global in names.items()}

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            cls = classes.get((module, name))
            if cls is not None:
                return cls
            if module == "predictionio_tpu" or module.startswith("predictionio_tpu."):
                raise pickle.UnpicklingError(
                    f"{what} names {module}.{name}, which has no "
                    "counterpart in predictionio_tpu_torch")
            return super().find_class(module, name)

    return _Unpickler(io.BytesIO(blob)).load()
