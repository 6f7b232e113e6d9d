"""Shared checker plumbing: parsed-source project model, findings,
inline suppression, and the reviewed baseline.

A :class:`Project` parses every ``*.py`` under the package once and
hands the same ASTs to every rule module, so a whole-repo run is one
parse pass plus cheap walks. Rules never read files themselves —
they go through the project, which also serves docs and test-corpus
text for the closure checks, so the whole framework can be pointed at a
synthetic fixture tree in tests.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

#: inline suppression marker: ``# pio-lint: disable=PL03`` (or a
#: comma-separated list) on the finding's line or the line above
_SUPPRESS = re.compile(r"#\s*pio-lint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``symbol`` anchors the finding to a code entity (qualified
    function, site name, flag string …) rather than a position, so the
    baseline key below survives unrelated edits to the file.
    """

    rule: str      #: rule family id, e.g. ``PL03``
    path: str      #: repo-relative posix path
    line: int      #: 1-based line (display only — not part of the key)
    symbol: str    #: stable anchor within the file
    message: str

    @property
    def key(self) -> str:
        """Stable identity used by the baseline: no line numbers."""
        return f"{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.symbol}] {self.message}"


class SourceModule:
    """One parsed source file plus its suppression map."""

    def __init__(self, name: str, path: Path, relpath: str) -> None:
        self.name = name
        self.path = path
        self.relpath = relpath
        self.text = path.read_text(encoding="utf-8")
        self.tree = ast.parse(self.text, filename=str(path))
        self._suppressed: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.text.splitlines(), start=1):
            m = _SUPPRESS.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self._suppressed[i] = rules

    def is_suppressed(self, rule: str, line: int) -> bool:
        """True when the finding's line (or the line above it) carries
        a ``# pio-lint: disable=`` comment naming ``rule``."""
        for ln in (line, line - 1):
            rules = self._suppressed.get(ln)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


class Project:
    """All parsed modules of one package tree, plus the docs and test
    corpus the closure rules compare against.

    ``root`` is the repo root (the directory holding the package dir,
    ``docs/``, ``tests/`` and ``conf/``) — for fixtures, any directory
    laid out the same way.
    """

    def __init__(self, root: Path, package: str = "predictionio_tpu_torch") -> None:
        self.root = Path(root)
        self.package = package
        self.modules: Dict[str, SourceModule] = {}
        pkg_dir = self.root / package
        for py in sorted(pkg_dir.rglob("*.py")):
            rel = py.relative_to(self.root)
            parts = list(rel.with_suffix("").parts)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            name = ".".join(parts)
            self.modules[name] = SourceModule(name, py, rel.as_posix())
        self._import_graph = None

    # -- module access --------------------------------------------------------

    def get(self, name: str) -> Optional[SourceModule]:
        return self.modules.get(name)

    def iter_modules(self) -> Iterator[SourceModule]:
        return iter(self.modules.values())

    def import_graph(self):
        """The shared module-scope import graph (built lazily once)."""
        if self._import_graph is None:
            from predictionio_tpu_torch.analysis.imports import ImportGraph

            self._import_graph = ImportGraph(self)
        return self._import_graph

    # -- non-code corpora -----------------------------------------------------

    def read_doc(self, relpath: str) -> str:
        """Text of a repo file (``docs/cli.md`` …), or ``""`` if absent
        — an absent doc makes every closure entry a finding, which is
        the honest failure mode."""
        p = self.root / relpath
        try:
            return p.read_text(encoding="utf-8")
        except OSError:
            return ""

    def test_corpus(self, exclude: Iterable[str] = ()) -> Dict[str, str]:
        """``tests/test_*.py`` name → text (raw-text corpus for the
        "every fault site is exercised" closure)."""
        skip = set(exclude)
        corpus: Dict[str, str] = {}
        tdir = self.root / "tests"
        if tdir.is_dir():
            for p in sorted(tdir.glob("test_*.py")):
                if p.name not in skip:
                    corpus[p.name] = p.read_text(encoding="utf-8")
        return corpus


# -- AST helpers shared by the rule modules -----------------------------------

def iter_functions(
    tree: ast.AST,
) -> Iterator[Tuple[str, ast.AST, Optional[str]]]:
    """Yield ``(qualname, funcnode, classname)`` for every function in
    the module, depth-first, with dotted qualnames (``Cls.meth``,
    ``Cls.meth.inner``)."""

    def walk(node: ast.AST, prefix: str, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child, cls
                yield from walk(child, q + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", child.name)

    yield from walk(tree, "", None)


def call_name(node: ast.Call) -> str:
    """Trailing name of a call target: ``a.b.c(...)`` → ``c``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, else ``""``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# -- baseline -----------------------------------------------------------------

def load_baseline(path: Path) -> Dict[str, str]:
    """``key → reason`` from a reviewed baseline file. Every entry must
    carry a non-empty reason — an unexplained baseline entry is just a
    suppressed bug."""
    doc = json.loads(path.read_text(encoding="utf-8"))
    entries = doc.get("entries", [])
    out: Dict[str, str] = {}
    for e in entries:
        key = e.get("key", "")
        reason = (e.get("reason") or "").strip()
        if not key or not reason:
            raise ValueError(
                f"baseline entry needs both key and a written reason: {e!r}")
        out[key] = reason
    return out
