"""Module-scope import graph over the package.

Edges model what Python *executes at import time*: only statements at
module level count (including those nested in module-level ``if``/
``try`` — conditional imports still run), and importing a submodule
also executes every ancestor package ``__init__``. Imports inside
function bodies are deliberately invisible — that is exactly the lazy
idiom that keeps a module importable without torch (the ops-box
verbs), and PL02's closure check must accept it.

``if TYPE_CHECKING:`` bodies are skipped: those imports never execute.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis.core import Project, SourceModule


def _is_type_checking_guard(node: ast.If) -> bool:
    t = node.test
    if isinstance(t, ast.Name) and t.id == "TYPE_CHECKING":
        return True
    if isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING":
        return True
    return False


def module_scope_statements(tree: ast.Module) -> Iterator[ast.stmt]:
    """Statements that run at import time, flattening module-level
    ``if``/``try``/``with`` blocks (minus TYPE_CHECKING guards)."""

    def walk(body):
        for stmt in body:
            if isinstance(stmt, ast.If):
                if _is_type_checking_guard(stmt):
                    yield from walk(stmt.orelse)
                    continue
                yield from walk(stmt.body)
                yield from walk(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                yield from walk(stmt.body)
                for h in stmt.handlers:
                    yield from walk(h.body)
                yield from walk(stmt.orelse)
                yield from walk(stmt.finalbody)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from walk(stmt.body)
            else:
                yield stmt

    yield from walk(tree.body)


def resolve_from_base(mod: SourceModule, node: ast.ImportFrom,
                      project: Project) -> Optional[str]:
    """Absolute dotted name of the module a ``from X import …`` names
    (before the imported attributes are considered)."""
    if node.level == 0:
        return node.module
    # relative: anchor at the importing module's package
    is_pkg = mod.path.name == "__init__.py"
    parts = mod.name.split(".")
    if not is_pkg:
        parts = parts[:-1]
    drop = node.level - 1
    if drop:
        parts = parts[: len(parts) - drop]
    if not parts:
        return node.module
    base = ".".join(parts)
    return f"{base}.{node.module}" if node.module else base


def module_scope_imports(mod: SourceModule,
                         project: Project) -> List[Tuple[str, int]]:
    """``(imported module name, lineno)`` for every import executed at
    module scope. ``from X import a`` yields ``X.a`` when that is a
    project module (importing a submodule) and ``X`` otherwise."""
    out: List[Tuple[str, int]] = []
    for stmt in module_scope_statements(mod.tree):
        out.extend(imports_of_statement(stmt, mod, project))
    return out


def imports_of_statement(stmt: ast.stmt, mod: SourceModule,
                         project: Project) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    if isinstance(stmt, ast.Import):
        for a in stmt.names:
            out.append((a.name, stmt.lineno))
    elif isinstance(stmt, ast.ImportFrom):
        base = resolve_from_base(mod, stmt, project)
        if base is None:
            return out
        for a in stmt.names:
            sub = f"{base}.{a.name}"
            out.append((sub if sub in project.modules else base,
                        stmt.lineno))
    return out


class ImportGraph:
    """Module-scope import edges, internal and external, for every
    project module."""

    def __init__(self, project: Project) -> None:
        self.project = project
        #: module → [(target module in project, lineno)]
        self.internal: Dict[str, List[Tuple[str, int]]] = {}
        #: module → [(external dotted name, lineno)]
        self.external: Dict[str, List[Tuple[str, int]]] = {}
        for mod in project.iter_modules():
            ints: List[Tuple[str, int]] = []
            exts: List[Tuple[str, int]] = []
            for name, line in module_scope_imports(mod, project):
                target = self._to_project_module(name)
                if target is not None:
                    ints.append((target, line))
                else:
                    exts.append((name, line))
            self.internal[mod.name] = ints
            self.external[mod.name] = exts

    def _to_project_module(self, name: str) -> Optional[str]:
        """Longest project-module prefix of ``name`` (``a.b.c`` imported
        where only ``a.b`` is a module → the attribute lives in
        ``a.b``), or None for external imports."""
        while name:
            if name in self.project.modules:
                return name
            if "." not in name:
                return None
            name = name.rsplit(".", 1)[0]
        return None

    @staticmethod
    def _ancestors(name: str) -> List[str]:
        parts = name.split(".")
        return [".".join(parts[:i]) for i in range(1, len(parts))]

    def external_path(self, root: str,
                      tops: Set[str]) -> Optional[List[str]]:
        """BFS from ``root`` through module-scope edges; the first chain
        reaching an external import whose top-level name is in ``tops``
        (e.g. ``{"torch"}``) is returned as
        ``[root, …, external_name]``. None when the closure is clean.

        Ancestor-package ``__init__``s are expanded too: importing
        ``a.b.c`` runs ``a/__init__`` and ``a/b/__init__``.
        """
        seen: Set[str] = set()
        parent: Dict[str, str] = {}
        queue: List[str] = []

        def enqueue(name: str, frm: Optional[str]) -> None:
            for cand in self._ancestors(name) + [name]:
                if cand in self.project.modules and cand not in seen:
                    seen.add(cand)
                    if frm is not None:
                        parent[cand] = frm
                    queue.append(cand)

        enqueue(root, None)
        i = 0
        while i < len(queue):
            cur = queue[i]
            i += 1
            for ext, _line in self.external.get(cur, ()):  # leaf check
                if ext.split(".")[0] in tops:
                    chain = [ext]
                    node: Optional[str] = cur
                    while node is not None:
                        chain.append(node)
                        node = parent.get(node)
                    return list(reversed(chain))
            for tgt, _line in self.internal.get(cur, ()):
                enqueue(tgt, cur)
        return None
