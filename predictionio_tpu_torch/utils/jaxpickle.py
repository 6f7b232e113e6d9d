"""Template blobs pickled under the JAX package's class names.

A template's model blob is a pickled dict that holds its params
dataclass. The JAX package pickles that class under its own module
path, so a blob either package writes names the JAX class. The port
writes its own dataclass under that name without importing the JAX
package, and maps the name back to its dataclass on load, so blobs
load in both directions. Any other name of the JAX package is refused:
loading it would import JAX.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Tuple


def dumps(d: Dict[str, Any], cls: type, jax_global: Tuple[str, str]) -> bytes:
    """Pickle ``d`` as the JAX package's ``pickle.dumps`` does, with
    ``cls`` named by ``jax_global`` (module, qualified name)."""

    class _Pickler(pickle._Pickler):
        # the stock pickler checks a global by importing its module;
        # this one writes the module and name strings for ``cls`` (the
        # pure-Python pickler's ``save_global`` is the hook)
        def save_global(self, obj, name=None):
            if obj is not cls:
                return super().save_global(obj, name)
            module, qualname = jax_global
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)

    buf = io.BytesIO()
    _Pickler(buf, max(pickle.DEFAULT_PROTOCOL, 4)).dump(d)
    return buf.getvalue()


def loads(blob: bytes, cls: type, jax_global: Tuple[str, str],
          what: str) -> Dict[str, Any]:
    """Unpickle ``blob`` with ``jax_global`` mapped to ``cls``; any other
    name of the JAX package raises ``UnpicklingError`` naming ``what``."""

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if (module, name) == jax_global:
                return cls
            if module == "predictionio_tpu" or module.startswith("predictionio_tpu."):
                raise pickle.UnpicklingError(
                    f"{what} names {module}.{name}, which has no "
                    "counterpart in predictionio_tpu_torch")
            return super().find_class(module, name)

    return _Unpickler(io.BytesIO(blob)).load()
