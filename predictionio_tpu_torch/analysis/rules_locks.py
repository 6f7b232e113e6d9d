"""PL03 — lock discipline in the data/storage tier.

Three sub-checks grounded in the filestore/segments hardening:

1. **Inconsistent lock usage** (the RacerD heuristic): in a class that
   owns a ``threading.Lock``/``RLock``/``Condition``, a write to a
   ``self._``-prefixed attribute *outside* any ``with self._lock:``
   block is flagged only when the SAME attribute is also written
   *under* the lock somewhere else in the class — the class itself
   declares the attribute shared, so the unlocked write is a race.
   ``__init__`` is exempt (no concurrent access before construction),
   as are methods whose name ends in ``_locked`` or whose docstring
   says the caller holds the lock.
2. **Blocking calls under a writer lock** in ``data/`` modules:
   ``fsync``/``pel_sync``/``time.sleep``/``urlopen``/``ensure_local``
   (the cold-tier fetch) executed while a ``with …lock:`` block is
   open stall every writer behind I/O. The deliberate durable-ack
   sites keep a reviewed baseline entry — the rule exists so NEW ones
   are a decision, not an accident.
3. **``open()`` without a context manager** in ``data/``, ``storage/``
   and ``tools/`` paths: a handle that escapes its expression leaks on
   the error path. Long-lived handles (the indexed-store WAL) are
   baselined with a justification.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceModule,
    call_name,
    iter_functions,
)

RULE = "PL03"

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_BLOCKING_CALLS = {"fsync", "pel_sync", "sleep", "urlopen", "urlretrieve",
                   "ensure_local"}
#: path prefixes (relative to the package dir) where sub-checks 2/3 run
_DATA_PATHS = ("data/",)
_OPEN_PATHS = ("data/", "storage/", "tools/")


def _caller_holds_lock(fn: ast.AST) -> bool:
    if getattr(fn, "name", "").endswith("_locked"):
        return True
    doc = ast.get_docstring(fn) or ""
    low = doc.lower()
    return "lock held" in low or "caller holds" in low or "holding the lock" in low


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` → ``X``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes assigned a Lock/RLock/Condition anywhere in the
    class (name must contain 'lock' or 'cv' — a Condition doubles as
    one)."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if call_name(node.value) in _LOCK_FACTORIES:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out.add(attr)
    return out


def _write_targets(stmt: ast.stmt) -> List[Tuple[str, int]]:
    """``self._x = …`` / ``self._x += …`` / ``self._x[k] = …`` →
    the attribute names written."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out: List[Tuple[str, int]] = []
    for t in targets:
        if isinstance(t, ast.Tuple):
            targets.extend(t.elts)
            continue
        node = t
        if isinstance(node, ast.Subscript):
            node = node.value
        attr = _self_attr(node)
        if attr is not None and attr.startswith("_"):
            out.append((attr, stmt.lineno))
    return out


def _is_lock_ctx(item: ast.withitem, lock_attrs: Set[str]) -> bool:
    """``with self.<lockattr>:`` — or any ``with X.lock…:`` (per-
    namespace lock objects like ``ns.lock`` in the filestore)."""
    ctx = item.context_expr
    attr = _self_attr(ctx)
    if attr is None and isinstance(ctx, ast.Attribute):
        attr = ctx.attr
    if attr is None:
        return False
    return (attr in lock_attrs or "lock" in attr.lower()
            or attr.lstrip("_") == "cv")


def _class_findings(mod: SourceModule, cls: ast.ClassDef) -> List[Finding]:
    lock_attrs = _lock_attrs(cls)
    if not lock_attrs:
        return []
    # (attr, method, line, locked?) for every self._x write in methods
    writes: List[Tuple[str, str, int, bool]] = []

    def scan(node: ast.AST, method: str, depth: int) -> None:
        for child in ast.iter_child_nodes(node):
            d = depth
            if isinstance(child, (ast.With, ast.AsyncWith)):
                if any(_is_lock_ctx(i, lock_attrs) for i in child.items):
                    d = depth + 1
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs run later, outside this frame
            for attr, line in _write_targets(child) \
                    if isinstance(child, ast.stmt) else []:
                if attr not in lock_attrs:
                    writes.append((attr, method, line, d > 0))
            scan(child, method, d)

    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name in ("__init__", "__new__", "__post_init__"):
            continue
        if _caller_holds_lock(stmt):
            continue
        scan(stmt, stmt.name, 0)

    guarded = {attr for attr, _m, _l, locked in writes if locked}
    out = []
    for attr, method, line, locked in writes:
        if locked or attr not in guarded:
            continue
        out.append(Finding(
            RULE, mod.relpath, line, f"{cls.name}.{method}.{attr}",
            f"unlocked write to self.{attr} — {cls.name} writes this "
            "attribute under its lock elsewhere, so this write races; "
            "take the lock, or rename the method *_locked if the "
            "caller already holds it"))
    return out


def _blocking_findings(mod: SourceModule) -> List[Finding]:
    out: List[Finding] = []

    def scan(node: ast.AST, qual: str, depth: int) -> None:
        for child in ast.iter_child_nodes(node):
            d = depth
            if isinstance(child, (ast.With, ast.AsyncWith)):
                if any(_is_lock_ctx(i, set()) for i in child.items):
                    d = depth + 1
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(child, f"{qual}.{child.name}" if qual else child.name, 0)
                continue
            elif isinstance(child, ast.ClassDef):
                scan(child, f"{qual}.{child.name}" if qual else child.name,
                     depth)
                continue
            if (isinstance(child, ast.Call) and d > 0
                    and call_name(child) in _BLOCKING_CALLS):
                name = call_name(child)
                out.append(Finding(
                    RULE, mod.relpath, child.lineno, f"{qual}:{name}",
                    f"blocking call {name}() while a writer lock is "
                    "held — every other writer stalls behind this I/O; "
                    "stage outside the lock and reacquire to publish "
                    "(the ship() pattern)"))
            scan(child, qual, d)

    scan(mod.tree, "", 0)
    return out


def _open_findings(mod: SourceModule) -> List[Finding]:
    with_ctx_calls: Set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call):
                    with_ctx_calls.add(id(ctx))
                    # contextlib.closing(open(...)) is fine too
                    for a in ctx.args:
                        if isinstance(a, ast.Call):
                            with_ctx_calls.add(id(a))
    out: List[Finding] = []
    funcs = [(q, fn) for q, fn, _c in iter_functions(mod.tree)]
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "open"
                and id(node) not in with_ctx_calls):
            qual = "module"
            for q, fn in funcs:
                if (fn.lineno <= node.lineno <= (fn.end_lineno or fn.lineno)):
                    qual = q  # innermost wins: keep scanning
            out.append(Finding(
                RULE, mod.relpath, node.lineno, f"{qual}:open",
                "open() without a context manager — the handle leaks "
                "on the error path; use `with open(...)`, or baseline "
                "a deliberately long-lived handle with the close() "
                "call site in the reason"))
    return out


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    pkg_prefix = project.package + "/"
    for mod in project.iter_modules():
        rel_in_pkg = mod.relpath[len(pkg_prefix):] \
            if mod.relpath.startswith(pkg_prefix) else mod.relpath
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(_class_findings(mod, node))
        if rel_in_pkg.startswith(_DATA_PATHS):
            out.extend(_blocking_findings(mod))
        if rel_in_pkg.startswith(_OPEN_PATHS):
            out.extend(_open_findings(mod))
    return out
