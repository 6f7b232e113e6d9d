"""PL05 — resilience hygiene on the serving paths.

1. **Retry scoping.** ``retry_with_backoff``/``retry_call`` default to
   ``retry_on=(Exception,)`` — which retries deterministic 4xx
   rejections (bad key, bad event) right along with transient faults,
   hammering the rejecting server. Every call site must pass an
   explicit ``retry_on=`` naming the transient types; the eventsink's
   raise-a-ValueError-for-4xx idiom is the model.
2. **No bare ``except:``** in ``server/`` modules: it swallows
   ``KeyboardInterrupt``/``SystemExit`` and turns shutdown into a hang.
3. **Retry-After on backpressure.** Any function in ``server/`` that
   constructs a 429 or 503 response must attach the hint — a
   ``Retry-After`` header and/or ``retryAfterSec`` body field —
   directly or by being one of the carrier helpers that do
   (``_throttled``/``_unavailable``/``_not_ready``). A 429 without a
   hint turns well-behaved clients into a synchronized retry stampede.
"""

from __future__ import annotations

import ast
from typing import List

from predictionio_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceModule,
    call_name,
    iter_functions,
)

RULE = "PL05"

_RETRY_CALLS = {"retry_with_backoff", "retry_call"}
_SERVER_PATH = "server/"
_HINT_STRINGS = ("Retry-After", "retryAfterSec", "retry_after")
_BACKPRESSURE = {429, 503}


def _retry_findings(project: Project, mod: SourceModule) -> List[Finding]:
    if mod.name == f"{project.package}.utils.resilience":
        return []
    out: List[Finding] = []
    funcs = [(q, fn) for q, fn, _c in iter_functions(mod.tree)]
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and call_name(node) in _RETRY_CALLS
                and not any(kw.arg == "retry_on" for kw in node.keywords)):
            qual = "module"
            for q, fn in funcs:
                if fn.lineno <= node.lineno <= (fn.end_lineno or fn.lineno):
                    qual = q
            out.append(Finding(
                RULE, mod.relpath, node.lineno, f"{qual}:retry_on",
                f"{call_name(node)}() without an explicit retry_on= — "
                "the default retries every Exception, including "
                "deterministic 4xx rejections; name the transient "
                "types (and raise 4xx as a type outside them, like "
                "eventsink does)"))
    return out


def _bare_except_findings(mod: SourceModule) -> List[Finding]:
    out: List[Finding] = []
    funcs = [(q, fn) for q, fn, _c in iter_functions(mod.tree)]
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            qual = "module"
            for q, fn in funcs:
                if fn.lineno <= node.lineno <= (fn.end_lineno or fn.lineno):
                    qual = q
            out.append(Finding(
                RULE, mod.relpath, node.lineno, f"{qual}:bare-except",
                "bare `except:` on a serving path swallows "
                "KeyboardInterrupt/SystemExit and masks real faults — "
                "catch Exception (or the specific types) instead"))
    return out


def _constructs_backpressure(fn: ast.AST) -> List[ast.Call]:
    hits = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if (kw.arg == "status"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value in _BACKPRESSURE):
                    hits.append(node)
    return hits


def _mentions_hint(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value in _HINT_STRINGS:
                return True
        # resp.headers["Retry-After"] = … / body["retryAfterSec"] = …
        if isinstance(node, ast.Attribute) and node.attr == "retry_after":
            return True
    return False


def _retry_after_findings(mod: SourceModule) -> List[Finding]:
    out: List[Finding] = []
    for qual, fn, _cls in iter_functions(mod.tree):
        hits = _constructs_backpressure(fn)
        # attribute to the INNERMOST constructing function only: a
        # method delegating to a nested helper is checked via the helper
        hits = [h for h in hits
                if not any(inner is not fn
                           and h in set(ast.walk(inner))
                           for _q, inner, _c in iter_functions(fn))]
        if not hits or _mentions_hint(fn):
            continue
        status = next(kw.value.value for kw in hits[0].keywords
                      if kw.arg == "status")
        out.append(Finding(
            RULE, mod.relpath, hits[0].lineno, f"{qual}:retry-after",
            f"{status} constructed without a Retry-After hint — "
            "backpressure without a wait window synchronizes client "
            "retries into a stampede; set resp.headers['Retry-After'] "
            "and the retryAfterSec body field (see the _throttled/"
            "_unavailable carriers)"))
    return out


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    pkg_prefix = project.package + "/"
    for mod in project.iter_modules():
        rel_in_pkg = mod.relpath[len(pkg_prefix):] \
            if mod.relpath.startswith(pkg_prefix) else mod.relpath
        out.extend(_retry_findings(project, mod))
        if rel_in_pkg.startswith(_SERVER_PATH):
            out.extend(_bare_except_findings(mod))
            out.extend(_retry_after_findings(mod))
    return out
