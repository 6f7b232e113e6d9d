"""PL02 — the port stays jax-free, and its ops-box verbs torch-free.

The JAX package's rule of this name keeps its ops-box verbs off jax.
The port has two invariants in its place:

(a) **No jax, anywhere.** No module of the package imports ``jax``,
    ``jaxlib``, ``flax``, ``optax`` or the JAX package
    (``predictionio_tpu``, ``predictionio_tpu.*``) at any scope: module
    level, function bodies and ``importlib.import_module("…")`` with a
    literal name alike. This is stricter than the closure check below,
    which allows lazy imports — the port has its own copy of whatever it
    needs from the JAX package, so there is no lazy escape hatch.

(b) **Torch-free ops-box verbs.** ``tools/cli.py`` declares
    ``_TORCH_VERBS``, the verbs whose command path may import torch.
    Every other verb (``models``, ``index``, ``fsck``, ``lint`` …) runs
    on a box without torch, so the modules its ``cmd_*`` function
    imports — plus everything THOSE import at module scope,
    transitively — must never reach ``torch``:

    1. ``build_parser()`` maps each verb to its ``cmd_*`` function
       (``x = sub.add_parser("verb", …)`` then
       ``x.set_defaults(fn=cmd_verb)``);
    2. each non-torch verb's command function is closed over the local
       call graph inside cli.py (helpers contribute their lazy imports
       too);
    3. every module imported anywhere inside those functions is walked
       through its **module-scope** import closure (the shared
       :class:`~predictionio_tpu_torch.analysis.imports.ImportGraph`)
       for a chain that ends at torch. Function-local imports inside the
       closure are invisible by construction: a lazy ``import torch``
       in a helper is the allowed pattern.

    The CLI module's own module-scope imports are checked the same way:
    ``--help`` must not pay a torch import either.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceModule,
    call_name,
    const_str,
    iter_functions,
)
from predictionio_tpu_torch.analysis.imports import (
    imports_of_statement,
    resolve_from_base,
)

RULE = "PL02"
#: top-level names the port never imports, at any scope
_JAX_TOPS = {"jax", "jaxlib", "flax", "optax", "predictionio_tpu"}
#: top-level names a torch-free verb must not reach at module scope
_TORCH_TOPS = {"torch"}


# -- (a) no jax at any scope --------------------------------------------------

def _imported_names(node: ast.AST, mod: SourceModule,
                    project: Project) -> List[str]:
    """Absolute module names one import statement (or a literal
    ``import_module`` call) brings in."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom):
        base = resolve_from_base(mod, node, project)
        return [base] if base else []
    if (isinstance(node, ast.Call) and call_name(node) == "import_module"
            and node.args):
        s = const_str(node.args[0])
        return [s] if s else []
    return []


def _jax_import_findings(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for mod in project.iter_modules():
        funcs = [(q, fn) for q, fn, _c in iter_functions(mod.tree)]
        for node in ast.walk(mod.tree):
            for name in _imported_names(node, mod, project):
                if name.split(".")[0] not in _JAX_TOPS:
                    continue
                qual = "module"
                for q, fn in funcs:
                    if fn.lineno <= node.lineno <= (fn.end_lineno
                                                    or fn.lineno):
                        qual = q  # innermost wins: keep scanning
                out.append(Finding(
                    RULE, mod.relpath, node.lineno, f"{qual}:{name}",
                    f"imports {name} — the port never imports jax, "
                    "flax, optax or the JAX package, at any scope; "
                    "keep a copy of what it needs in the port"))
    return out


# -- (b) torch-free verb closure ----------------------------------------------

def _torch_verbs(cli: SourceModule) -> Set[str]:
    """Literal ``_TORCH_VERBS = {...}`` set, empty when absent."""
    for node in cli.tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "_TORCH_VERBS"
                        for t in node.targets)
                and isinstance(node.value, (ast.Set, ast.Tuple, ast.List))):
            return {s for e in node.value.elts
                    if (s := const_str(e)) is not None}
    return set()


def _verb_map(cli: SourceModule) -> Dict[str, str]:
    """verb → cmd function name, from the add_parser/set_defaults idiom
    anywhere in the module (normally inside ``build_parser``)."""
    var_verb: Dict[str, str] = {}
    verbs: Dict[str, str] = {}
    for node in ast.walk(cli.tree):
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and call_name(node.value) == "add_parser"
                and node.value.args):
            verb = const_str(node.value.args[0])
            if verb:
                var_verb[node.targets[0].id] = verb
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "set_defaults"
              and isinstance(node.func.value, ast.Name)):
            verb = var_verb.get(node.func.value.id)
            if verb is None:
                continue
            for kw in node.keywords:
                if kw.arg == "fn" and isinstance(kw.value, ast.Name):
                    verbs[verb] = kw.value.id
    return verbs


def _local_functions(cli: SourceModule) -> Dict[str, ast.AST]:
    return {n.name: n for n in cli.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _reachable_locals(entry: str, funcs: Dict[str, ast.AST]) -> Set[str]:
    """Fixpoint over the intra-module call graph: every local function
    reachable from ``entry`` by plain-name calls or references."""
    seen: Set[str] = set()
    todo = [entry]
    while todo:
        name = todo.pop()
        if name in seen or name not in funcs:
            continue
        seen.add(name)
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Name) and node.id in funcs:
                todo.append(node.id)
    return seen


def _function_imports(fn: ast.AST, cli: SourceModule,
                      project: Project) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.extend(imports_of_statement(node, cli, project))
        elif (isinstance(node, ast.Call)
              and call_name(node) == "import_module"
              and node.args):
            s = const_str(node.args[0])
            if s:
                out.append((s, node.lineno))
    return out


def _closure_finding(project: Project, cli: SourceModule, root_mod: str,
                     line: int, context: str) -> Optional[Finding]:
    top = root_mod.split(".")[0]
    if top in _TORCH_TOPS:
        chain: Optional[List[str]] = [root_mod]
    elif top == project.package:
        # from X import attr resolved to a non-module: walk up
        name = root_mod
        while name and name not in project.modules:
            name = name.rsplit(".", 1)[0] if "." in name else ""
        if not name:
            return None
        chain = project.import_graph().external_path(name, _TORCH_TOPS)
    else:
        return None  # external, not torch (stdlib, numpy, …)
    if chain is None:
        return None
    return Finding(
        RULE, cli.relpath, line, f"{context}:{root_mod}",
        f"{context} reaches torch through module-scope imports: "
        + " -> ".join(chain)
        + " — break the chain or make the torch import lazy "
          "(function-local), or list the verb in _TORCH_VERBS")


def _torch_closure_findings(project: Project) -> List[Finding]:
    cli = project.get(f"{project.package}.tools.cli")
    if cli is None:
        return []
    graph = project.import_graph()
    out: List[Finding] = []

    # the CLI module itself: its module-scope closure must be torch-free
    for name, line in graph.internal[cli.name] + graph.external[cli.name]:
        f = _closure_finding(project, cli, name, line, "cli-startup")
        if f:
            out.append(f)

    torch_verbs = _torch_verbs(cli)
    funcs = _local_functions(cli)
    for verb, fn_name in sorted(_verb_map(cli).items()):
        if verb in torch_verbs or fn_name not in funcs:
            continue
        for local in sorted(_reachable_locals(fn_name, funcs)):
            for mod_name, line in _function_imports(
                    funcs[local], cli, project):
                f = _closure_finding(project, cli, mod_name, line,
                                     f"verb '{verb}'")
                if f:
                    out.append(f)
    # one verb importing a torch-bound module can be reached through
    # many helpers; identical keys collapse to one finding
    uniq: Dict[str, Finding] = {}
    for f in out:
        uniq.setdefault(f.key, f)
    return list(uniq.values())


def check(project: Project) -> List[Finding]:
    return _jax_import_findings(project) + _torch_closure_findings(project)
