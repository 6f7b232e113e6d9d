"""Lint orchestration: run rule families over a project, apply inline
suppressions and the reviewed baseline, and shape the report the CLI
(and CI) consume.

Kept separate from the CLI so tests can call :func:`run_lint` on
fixture trees directly. The port's findings are baselined in their own
file, ``conf/lint-baseline-torch.json``; ``conf/lint-baseline.json`` is
the JAX package's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from predictionio_tpu_torch.analysis import (
    rules_jaxfree,
    rules_locks,
    rules_registry,
    rules_resilience,
    rules_trace,
)
from predictionio_tpu_torch.analysis.core import Finding, Project, load_baseline

#: rule family id → checker. Adding a family = one module with a
#: ``check(project) -> list[Finding]`` plus one row here.
RULES: Dict[str, Callable[[Project], List[Finding]]] = {
    "PL01": rules_trace.check,
    "PL02": rules_jaxfree.check,
    "PL03": rules_locks.check,
    "PL04": rules_registry.check,
    "PL05": rules_resilience.check,
}

DEFAULT_BASELINE = "conf/lint-baseline-torch.json"


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)  #: actionable
    baselined: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    stale_baseline: List[str] = field(default_factory=list)
    rules: List[str] = field(default_factory=list)
    files: int = 0
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> Dict:
        return {
            "ok": self.ok,
            "rules": self.rules,
            "files": self.files,
            "duration_s": round(self.duration_s, 3),
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "symbol": f.symbol, "key": f.key, "message": f.message}
                for f in self.findings
            ],
            "baselined": len(self.baselined),
            "suppressed": self.suppressed,
            "stale_baseline": self.stale_baseline,
        }


def default_root() -> Path:
    """The repo root: the directory holding the package dir (this file
    is ``<root>/predictionio_tpu_torch/analysis/runner.py``)."""
    return Path(__file__).resolve().parents[2]


def run_lint(
    root: Optional[Path] = None,
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[Path] = None,
    use_baseline: bool = True,
    package: str = "predictionio_tpu_torch",
) -> LintReport:
    t0 = time.monotonic()
    root = Path(root) if root is not None else default_root()
    selected = list(rules) if rules else sorted(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule id(s): {unknown} "
                         f"(known: {sorted(RULES)})")

    project = Project(root, package=package)
    raw: List[Finding] = []
    for rule_id in selected:
        raw.extend(RULES[rule_id](project))

    report = LintReport(rules=selected, files=len(project.modules))

    by_path = {m.relpath: m for m in project.iter_modules()}
    visible: List[Finding] = []
    for f in raw:
        mod = by_path.get(f.path)
        if mod is not None and mod.is_suppressed(f.rule, f.line):
            report.suppressed += 1
        else:
            visible.append(f)

    accepted: Dict[str, str] = {}
    if use_baseline:
        path = Path(baseline) if baseline is not None \
            else root / DEFAULT_BASELINE
        if path.is_file():
            accepted = load_baseline(path)

    for f in visible:
        (report.baselined if f.key in accepted
         else report.findings).append(f)
    matched = {f.key for f in report.baselined}
    report.stale_baseline = sorted(k for k in accepted if k not in matched)

    report.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    report.duration_s = time.monotonic() - t0
    return report
