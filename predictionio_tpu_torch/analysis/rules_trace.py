"""PL01 — trace-safety / recompile hazards, the part with a torch meaning.

Two sub-checks of the JAX package's rule of this name, numbered as
there:

1. **Serving modules stay jax-agnostic.** ``server/engine_server.py``,
   ``server/batching.py``, ``server/router.py`` and ``server/http.py``
   dispatch through duck-typed hooks and contain zero references to
   jax; any reference appearing there (even a lazy import) is a hazard
   on the request path.
4. **Cache-key hygiene.** ``*_aot_key`` functions must derive keys from
   geometry only: calls into ``time``/``random``/``uuid``/``id()``/
   ``os.getpid`` make every request a cache miss and a fresh warm-up of
   the bucket's program (``models/als.py`` and ``ann/scorer.py`` key
   their warmed serving programs this way).

The JAX rule's sub-checks 2 (``lower().compile()`` chains outside the
executable cache's builders) and 3 (traced Python values leaking out of
jitted functions) are not ported: the port compiles no XLA program and
traces nothing, so neither hazard has a torch counterpart.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from predictionio_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceModule,
    dotted_name,
    iter_functions,
)

RULE = "PL01"

#: request-path modules that must never mention jax (relative to the
#: package root)
SERVING_MODULES = ("server.engine_server", "server.batching",
                   "server.router", "server.http")

_NONGEOMETRY = ("time.", "random.", "uuid.", "datetime.", "os.getpid")


def _findings_serving_jax(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for rel in SERVING_MODULES:
        mod = project.get(f"{project.package}.{rel}")
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            hit: Optional[str] = None
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] in ("jax", "jaxlib"):
                        hit = a.name
            elif isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[0] in ("jax", "jaxlib"):
                    hit = node.module or ""
            elif isinstance(node, ast.Name) and node.id == "jax":
                hit = "jax"
            if hit:
                out.append(Finding(
                    RULE, mod.relpath, node.lineno, f"jax:{hit}",
                    f"serving module references {hit}: request-path "
                    "modules must stay jax-agnostic (compiles belong "
                    "behind server/aot.py's ExecutableCache)"))
    return out


def _findings_key_hygiene(mod: SourceModule) -> List[Finding]:
    out: List[Finding] = []
    for qual, fn, _cls in iter_functions(mod.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        if not (fn.name == "aot_key" or fn.name.endswith("_aot_key")):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            bad = (d == "id"
                   or any(d.startswith(p) or d == p.rstrip(".")
                          for p in _NONGEOMETRY))
            if bad:
                out.append(Finding(
                    RULE, mod.relpath, node.lineno, f"{qual}:{d}",
                    f"non-geometry value from {d}() in an executable "
                    "cache key — every call becomes a cache miss and a "
                    "fresh XLA compile; keys must be pure geometry "
                    "(shapes, dtypes, backend)"))
    return out


def check(project: Project) -> List[Finding]:
    out = _findings_serving_jax(project)
    for mod in project.iter_modules():
        out.extend(_findings_key_hygiene(mod))
    return out
