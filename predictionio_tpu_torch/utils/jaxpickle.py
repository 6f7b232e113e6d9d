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
from typing import Any, Dict, Sequence, Tuple

#: the port's class → the JAX package's (module, qualified name) of it
Names = Dict[type, Tuple[str, str]]


def dumps(obj: Any, names: Names, plain: Sequence[Any] = ()) -> bytes:
    """Pickle ``obj`` as the JAX package's ``pickle.dumps`` does, with each
    class of ``names`` named by its JAX (module, qualified name).

    The pickler that can rename classes is the pure-Python one, which is
    slow on large containers. Each object of ``plain`` (found by
    identity inside ``obj``: a container of built-in values and arrays,
    with no cycles and no class of ``names``, such as a dict of lists of
    ints) is written by the C pickler instead, with no memo: the same
    value on load, its inner shared references written out in full."""

    plain_ids = {id(o) for o in plain}

    class _Plain(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, type) and o in names or type(o) in names:
                raise pickle.PicklingError(
                    f"{type(o).__name__} inside an object passed as plain")
            return NotImplemented

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

        def save(self, obj, save_persistent_id=True):
            if id(obj) not in plain_ids:
                return super().save(obj, save_persistent_id)
            # protocol 3 has no frames: its opcodes between the header
            # and STOP push the object in any protocol-4 stream
            buf = io.BytesIO()
            p = _Plain(buf, 3)
            p.fast = True
            p.dump(obj)
            self.write(buf.getvalue()[2:-1])

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
