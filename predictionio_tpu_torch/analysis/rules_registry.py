"""PL04 — registry/docs/tests closure.

Generalizes the audit ``tests/test_faults_registry.py`` pioneered: a
name registered in code but absent from its docs anchor is a drill
nobody knows to run / a series nobody graphs / a flag nobody finds.
Three registries, each with its documentation anchor:

=====================  ======================  =======================
registry               collected from          must appear in
=====================  ======================  =======================
fault injection sites  ``faults.inject(s)``   utils/faults.py
                       / ``ahit`` / ``hit`` /  Known-sites table,
                       ``corrupt_bytes`` /     docs/operations.md,
                       ``corrupt`` literals +  and ≥ 1 test file
                       the two dynamic sites
Prometheus series      ``REGISTRY.counter/     docs/observability.md
                       gauge/histogram("x")``
                       + direct constructors
fleet/SLO/incident     any ``pio_fleet_*`` /   docs/observability.md
series                 ``pio_slo_*`` /
                       ``pio_incident_*``
                       string literal (these
                       names are often built
                       dynamically, e.g. the
                       federation rename)
CLI flags              ``add_argument("--x")`` docs/cli.md
                       in tools/cli.py
environment flags      ``environ.get("PIO_x")``  docs/cli.md
                       / ``os.getenv`` /
                       ``environ["PIO_x"]``
=====================  ======================  =======================

The fault-site closure is bidirectional (a table row no code wires is
stale) and includes test coverage — every documented site must be
exercised by some ``tests/test_*.py`` (``tests/test_faults_registry.py``
itself, the audit of the JAX package's table, does not count).

The analysis package itself is excluded from collection: its sources
quote these very literals as examples.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis.core import (
    Finding,
    Project,
    SourceModule,
    call_name,
    const_str,
)

RULE = "PL04"

_FAULT_CALLS = {"inject", "ahit", "hit", "corrupt", "corrupt_bytes"}
_SITE_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
_TABLE_RE = re.compile(r"^``([a-z0-9_]+(?:\.[a-z0-9_]+)+)``", re.MULTILINE)
_METRIC_CALLS = {"counter", "gauge", "histogram"}
_METRIC_CTORS = {"Counter", "Gauge", "Histogram"}
_METRIC_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_AUDIT_TEST = "test_faults_registry.py"


def _excluded(project: Project, mod: SourceModule) -> bool:
    return mod.name.startswith(f"{project.package}.analysis")


# -- fault sites --------------------------------------------------------------

def table_sites(project: Project) -> Set[str]:
    """Sites in the Known-sites table of utils/faults.py's docstring —
    the documentation anchor everything else is compared against."""
    mod = project.get(f"{project.package}.utils.faults")
    if mod is None:
        return set()
    doc = ast.get_docstring(mod.tree) or ""
    return set(_TABLE_RE.findall(doc))


def wired_sites(project: Project) -> Dict[str, List[Tuple[str, int]]]:
    """Every site the package wires: literal injection calls plus the
    two dynamic constructions (remote stores build ``models.{kind}``,
    the segment read path uses the ``FAULT_SEGMENT`` constant)."""
    faults_mod = f"{project.package}.utils.faults"
    found: Dict[str, List[Tuple[str, int]]] = {}

    def note(site: str, where: str, line: int) -> None:
        found.setdefault(site, []).append((where, line))

    for mod in project.iter_modules():
        if mod.name == faults_mod or _excluded(project, mod):
            continue
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and call_name(node) in _FAULT_CALLS and node.args):
                s = const_str(node.args[0])
                if s and _SITE_RE.match(s):
                    note(s, mod.relpath, node.lineno)
    remote = project.get(f"{project.package}.storage.remote")
    if remote is not None:
        for node in ast.walk(remote.tree):
            if (isinstance(node, ast.Call)
                    and call_name(node) == "_init_resilience" and node.args):
                # fault_site= overrides the default models.{kind} site
                site = next((const_str(kw.value) for kw in node.keywords
                             if kw.arg == "fault_site"), None)
                kind = const_str(node.args[0])
                if site:
                    note(site, remote.relpath, node.lineno)
                elif kind:
                    note(f"models.{kind}", remote.relpath, node.lineno)
    segments = project.get(f"{project.package}.data.segments")
    if segments is not None:
        for node in segments.tree.body:
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "FAULT_SEGMENT"
                            for t in node.targets)):
                s = const_str(node.value)
                if s:
                    note(s, segments.relpath, node.lineno)
    return found


def fault_site_closure(project: Project) -> List[Finding]:
    """The four directions of the fault-site audit, as findings.
    The JAX package's twin of this function backs
    ``tests/test_faults_registry.py``."""
    faults_mod = project.get(f"{project.package}.utils.faults")
    if faults_mod is None:
        return []
    out: List[Finding] = []
    table = table_sites(project)
    wired = wired_sites(project)
    if not table:
        out.append(Finding(
            RULE, faults_mod.relpath, 1, "known-sites-table",
            "Known-sites table missing from utils/faults.py docstring "
            "— the fault registry has lost its documentation anchor"))
        return out
    for site in sorted(set(wired) - table):
        where, line = wired[site][0]
        out.append(Finding(
            RULE, where, line, f"fault-site:{site}",
            f"fault site '{site}' is wired in code but missing from "
            "the utils/faults.py Known-sites table"))
    for site in sorted(table - set(wired)):
        out.append(Finding(
            RULE, faults_mod.relpath, 1, f"fault-site-stale:{site}",
            f"Known-sites table documents '{site}' but no code injects "
            "it — stale row or a dropped injection point"))
    ops = project.read_doc("docs/operations.md")
    for site in sorted(table):
        if site not in ops:
            out.append(Finding(
                RULE, faults_mod.relpath, 1, f"fault-site-doc:{site}",
                f"fault site '{site}' missing from docs/operations.md "
                "— a chaos drill nobody knows to run"))
    corpus = project.test_corpus(exclude=(_AUDIT_TEST,))
    for site in sorted(table):
        if not any(site in text for text in corpus.values()):
            out.append(Finding(
                RULE, faults_mod.relpath, 1, f"fault-site-test:{site}",
                f"fault site '{site}' is exercised by no test — the "
                "robustness claim is unchecked"))
    # the dynamic-construction invariant the old audit asserted
    remote = project.get(f"{project.package}.storage.remote")
    if remote is not None and 'f"models.{kind}"' not in remote.text:
        out.append(Finding(
            RULE, remote.relpath, 1, "models-kind-fstring",
            "remote stores no longer build their fault site from the "
            "kind — the models.* audit below is blind"))
    return out


# -- Prometheus series --------------------------------------------------------

def metric_series(project: Project) -> Dict[str, Tuple[str, int]]:
    """series name → first (path, line) where it is created."""
    out: Dict[str, Tuple[str, int]] = {}
    for mod in project.iter_modules():
        if _excluded(project, mod):
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            name = call_name(node)
            is_factory = (isinstance(node.func, ast.Attribute)
                          and name in _METRIC_CALLS)
            is_ctor = isinstance(node.func, ast.Name) and name in _METRIC_CTORS
            if not (is_factory or is_ctor):
                continue
            s = const_str(node.args[0])
            if s and _METRIC_RE.match(s) and "_" in s:
                out.setdefault(s, (mod.relpath, node.lineno))
    return out


def _metric_findings(project: Project) -> List[Finding]:
    doc = project.read_doc("docs/observability.md")
    out: List[Finding] = []
    for series, (path, line) in sorted(metric_series(project).items()):
        if series not in doc:
            out.append(Finding(
                RULE, path, line, f"metric:{series}",
                f"Prometheus series '{series}' is not documented in "
                "docs/observability.md — a signal nobody graphs or "
                "alerts on"))
    return out


_PREFIXED_RE = re.compile(
    r"^pio_(fleet|slo|incident|ann_shard)_[a-z0-9_]*$")


def prefixed_series(project: Project) -> Dict[str, Tuple[str, int]]:
    """Every ``pio_fleet_*`` / ``pio_slo_*`` / ``pio_incident_*`` /
    ``pio_ann_shard_*`` string constant in the
    package, wherever it appears. These series names are often built
    dynamically (federation renames ``pio_*`` to ``pio_fleet_*`` at
    scrape time; ``pio top`` queries the renamed series by literal), so
    the factory-call collector above never sees them — but an
    undocumented fleet or SLO series is exactly the signal an on-call
    needs and cannot find."""
    out: Dict[str, Tuple[str, int]] = {}
    for mod in project.iter_modules():
        if _excluded(project, mod):
            continue
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and _PREFIXED_RE.match(node.value)):
                out.setdefault(node.value, (mod.relpath, node.lineno))
    return out


def _prefixed_findings(project: Project) -> List[Finding]:
    doc = project.read_doc("docs/observability.md")
    out: List[Finding] = []
    for series, (path, line) in sorted(prefixed_series(project).items()):
        if series not in doc:
            out.append(Finding(
                RULE, path, line, f"metric:{series}",
                f"fleet/SLO series '{series}' is not documented in "
                "docs/observability.md — a paging signal nobody can "
                "look up"))
    return out


# -- CLI flags ----------------------------------------------------------------

def cli_flags(project: Project) -> Dict[str, Tuple[str, int]]:
    cli = project.get(f"{project.package}.tools.cli")
    out: Dict[str, Tuple[str, int]] = {}
    if cli is None:
        return out
    for node in ast.walk(cli.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            for arg in node.args:
                s = const_str(arg)
                if s and s.startswith("--"):
                    out.setdefault(s, (cli.relpath, node.lineno))
    return out


def _flag_findings(project: Project) -> List[Finding]:
    doc = project.read_doc("docs/cli.md")
    out: List[Finding] = []
    for flag, (path, line) in sorted(cli_flags(project).items()):
        if flag not in doc:
            out.append(Finding(
                RULE, path, line, f"flag:{flag}",
                f"CLI flag '{flag}' is not documented in docs/cli.md"))
    return out


# -- environment flags --------------------------------------------------------

_ENV_RE = re.compile(r"^PIO_[A-Z0-9_]+$")


def _is_environ(node: ast.AST) -> bool:
    return ((isinstance(node, ast.Name) and node.id == "environ")
            or (isinstance(node, ast.Attribute) and node.attr == "environ"))


def env_flags(project: Project) -> Dict[str, Tuple[str, int]]:
    """Every ``PIO_*`` environment variable the package reads —
    ``environ.get``/``environ.setdefault``/``os.getenv``/
    ``environ["..."]`` — mapped to the first (path, line) reading it.
    An env knob that ships undocumented (PIO_PALLAS_GRAM and friends
    select entire device code paths) is a tuning surface operators
    cannot discover."""
    out: Dict[str, Tuple[str, int]] = {}
    for mod in project.iter_modules():
        if _excluded(project, mod):
            continue
        for node in ast.walk(mod.tree):
            s = None
            if isinstance(node, ast.Call) and node.args:
                name = call_name(node)
                if name == "getenv":
                    s = const_str(node.args[0])
                elif (name in ("get", "setdefault", "pop")
                      and isinstance(node.func, ast.Attribute)
                      and _is_environ(node.func.value)):
                    s = const_str(node.args[0])
            elif isinstance(node, ast.Subscript) and _is_environ(node.value):
                s = const_str(node.slice)
            if s and _ENV_RE.match(s):
                out.setdefault(s, (mod.relpath, node.lineno))
    return out


def _env_findings(project: Project) -> List[Finding]:
    doc = project.read_doc("docs/cli.md")
    out: List[Finding] = []
    for var, (path, line) in sorted(env_flags(project).items()):
        if var not in doc:
            out.append(Finding(
                RULE, path, line, f"env:{var}",
                f"environment flag '{var}' is read by the package but "
                "not documented in docs/cli.md — an invisible knob"))
    return out


def check(project: Project) -> List[Finding]:
    return (fault_site_closure(project)
            + _metric_findings(project)
            + _prefixed_findings(project)
            + _flag_findings(project)
            + _env_findings(project))
