"""`pio lint` over the port (predictionio_tpu_torch/analysis/), held
against the JAX package's analysis on the CPU in one process.

The fixture sources of tests/test_lint.py are laid out twice, once under
``predictionio_tpu/`` for the JAX runner and once under
``predictionio_tpu_torch/`` for the port's: PL03, PL04, PL05 and PL01's
sub-checks 1 and 4 must give the same findings with the package prefix
swapped, on the fixtures and on the real tree. PL02 is the port's own
rule (no jax at any scope, torch-free ops-box verbs) and has cases of
its own. No case here bounds the wall clock.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from predictionio_tpu.analysis.runner import run_lint as jax_run_lint
from predictionio_tpu_torch.analysis.core import load_baseline
from predictionio_tpu_torch.analysis.runner import DEFAULT_BASELINE, RULES, run_lint

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = "predictionio_tpu"
PKG = "predictionio_tpu_torch"


def make_tree(root, pkg, files):
    """Lay out a synthetic repo under ``root``: {relpath: source}, with
    ``{pkg}`` in paths and sources standing for the package name."""
    for rel, text in files.items():
        p = root / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text).replace("{pkg}", pkg), encoding="utf-8")
    (root / pkg).mkdir(parents=True, exist_ok=True)
    (root / pkg / "__init__.py").touch()
    return root


def rows(report, pkg):
    """(rule, path, line, symbol, message) of each finding, the package
    prefix of paths and symbols replaced by ``{pkg}``."""
    def norm(s):
        return s.replace(pkg, "{pkg}")
    return sorted((f.rule, norm(f.path), f.line, norm(f.symbol), norm(f.message))
                  for f in report.findings)


def symbols(report):
    return {f.symbol for f in report.findings}


# -- the fixtures of tests/test_lint.py ---------------------------------------

_PL05_SERVER = """\
    def fetch(call, retry_with_backoff):
        return retry_with_backoff(call)

    def fetch_ok(call, retry_with_backoff):
        return retry_with_backoff(call, retry_on=(TimeoutError,))

    def swallow():
        try:
            return 1
        except:
            return None

    def careful():
        try:
            return 1
        except Exception:
            return None

    def throttle(Response):
        return Response(status=429)

    def throttle_ok(Response):
        resp = Response(status=429)
        resp.headers["Retry-After"] = "1"
        return resp
"""

_PL04_CLOSURE = {
    "{pkg}/utils/__init__.py": "",
    "{pkg}/utils/faults.py": '''\
        """Fault registry.

        Known sites
        -----------
        ``a.b``           documented, wired, drilled, tested
        ``stale.site``    documented but wired nowhere
        ``undoc.site``    wired but absent from operations.md
        ``untested.site`` wired and drilled but never tested
        """

        FAULTS = None
    ''',
    "{pkg}/data/__init__.py": "",
    "{pkg}/data/x.py": """\
        def f(faults, REGISTRY):
            faults.inject("a.b")
            faults.inject("ghost.site")
            faults.inject("undoc.site")
            faults.inject("untested.site")
            REGISTRY.counter("pio_ghost_total")
            REGISTRY.counter("pio_ok_total")
    """,
    "{pkg}/tools/__init__.py": "",
    "{pkg}/tools/cli.py": """\
        def build_parser(p):
            p.add_argument("--documented-flag")
            p.add_argument("--undocumented-flag")
            return p
    """,
    "docs/operations.md": "drills: a.b, stale.site, untested.site\n",
    "docs/observability.md": "series: pio_ok_total\n",
    "docs/cli.md": "flags: --documented-flag\n",
    "tests/test_sites.py": "# exercises a.b stale.site undoc.site\n",
}

#: case id → (rule, files, the symbols the case must find)
FIXTURES = {
    "PL01-serving-jax": ("PL01", {
        "{pkg}/server/engine_server.py": "import jax\n",
    }, {"jax:jax"}),
    "PL01-aot-key": ("PL01", {
        "{pkg}/ops/keys.py": """\
            import time

            def bucket_aot_key(x):
                return (x.shape, time.time())

            def good_aot_key(x):
                return (x.shape, str(x.dtype))
        """,
    }, {"bucket_aot_key:time.time"}),
    "PL03-unlocked-write": ("PL03", {
        "{pkg}/server/state.py": """\
            import threading

            class Counter:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0

                def bump(self):
                    with self._lock:
                        self._n += 1

                def reset(self):
                    self._n = 0
        """,
    }, {"Counter.reset._n"}),
    "PL03-locked-conventions": ("PL03", {
        "{pkg}/server/state.py": """\
            import threading

            class Counter:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0

                def bump(self):
                    with self._lock:
                        self._n += 1
                        self._reset_locked()

                def _reset_locked(self):
                    self._n = 0

                def _drain(self):
                    \"\"\"Caller holds the lock.\"\"\"
                    self._n = 0
        """,
    }, set()),
    "PL03-blocking-under-lock": ("PL03", {
        "{pkg}/data/store.py": """\
            import os
            import threading

            class Store:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._fd = 0

                def append(self, b):
                    with self._lock:
                        os.fsync(self._fd)

                def staged(self, b):
                    os.fsync(self._fd)  # outside the lock: fine
                    with self._lock:
                        pass
        """,
    }, {"Store.append:fsync"}),
    "PL03-blocking-outside-data": ("PL03", {
        "{pkg}/utils/misc.py": """\
            import os
            import threading

            _lock = threading.Lock()

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def f(self, fd):
                    with self._lock:
                        os.fsync(fd)
        """,
    }, set()),
    "PL03-open": ("PL03", {
        "{pkg}/storage/wal.py": """\
            def read_all(path):
                fh = open(path)
                data = fh.read()
                fh.close()
                return data

            def read_ok(path):
                with open(path) as fh:
                    return fh.read()
        """,
    }, {"read_all:open"}),
    "PL04-closure": ("PL04", _PL04_CLOSURE, {
        "fault-site:ghost.site", "fault-site-stale:stale.site",
        "fault-site-doc:undoc.site", "fault-site-test:untested.site",
        "metric:pio_ghost_total", "flag:--undocumented-flag"}),
    "PL04-missing-table": ("PL04", {
        "{pkg}/utils/__init__.py": "",
        "{pkg}/utils/faults.py": '"""No table here."""\n',
    }, {"known-sites-table"}),
    "PL04-env-flags": ("PL04", {
        "{pkg}/ops/__init__.py": "",
        "{pkg}/ops/kern.py": """\
            import os

            def modes():
                a = os.environ.get("PIO_DOCUMENTED_FLAG", "auto")
                b = os.environ.get("PIO_GHOST_GET", "")
                c = os.getenv("PIO_GHOST_GETENV")
                d = os.environ["PIO_GHOST_SUBSCRIPT"]
                e = os.environ.setdefault("PIO_GHOST_SETDEFAULT", "1")
                f = os.environ.get("XLA_FLAGS", "")   # not PIO_*
                return a, b, c, d, e, f
        """,
        "docs/cli.md": "env: PIO_DOCUMENTED_FLAG\n",
    }, {"env:PIO_GHOST_GET", "env:PIO_GHOST_GETENV", "env:PIO_GHOST_SUBSCRIPT",
        "env:PIO_GHOST_SETDEFAULT"}),
    "PL05-server": ("PL05", {"{pkg}/server/h.py": _PL05_SERVER},
                    {"fetch:retry_on", "swallow:bare-except", "throttle:retry-after"}),
    "PL05-retry-outside-server": ("PL05", {
        "{pkg}/storage/s.py": """\
            def pull(call, retry_call):
                return retry_call(call)
        """,
    }, {"pull:retry_on"}),
    "PL05-inline-suppression": ("PL05", {
        "{pkg}/server/h.py": """\
            def fetch(call, retry_with_backoff):
                # pio-lint: disable=PL05
                return retry_with_backoff(call)
        """,
    }, set()),
}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_fixture_findings_equal_the_jax_runners(tmp_path, case):
    rule, files, expected = FIXTURES[case]
    jroot = make_tree(tmp_path / "jax", JAX_PKG, files)
    proot = make_tree(tmp_path / "port", PKG, files)
    theirs = jax_run_lint(root=jroot, rules=[rule], use_baseline=False, package=JAX_PKG)
    mine = run_lint(root=proot, rules=[rule], use_baseline=False)
    assert {s.replace(PKG, "{pkg}") for s in symbols(mine)} == expected
    assert rows(mine, PKG) == rows(theirs, JAX_PKG)
    assert (mine.files, mine.suppressed) == (theirs.files, theirs.suppressed)


def test_pl01_leaves_out_the_compile_and_traced_value_subchecks(tmp_path):
    """The JAX rule's sub-checks 2 and 3 fire on these fixtures; the
    port's PL01 has no torch counterpart for them and stays quiet."""
    files = {
        "{pkg}/ops/kern.py": """\
            def compile_now(fn, x):
                return fn.lower(x).compile()
        """,
        "{pkg}/ops/act.py": """\
            import jax

            @jax.jit
            def relu(x):
                if x > 0:
                    return x
                return 0 * x
        """,
    }
    theirs = jax_run_lint(root=make_tree(tmp_path / "jax", JAX_PKG, files),
                          rules=["PL01"], use_baseline=False, package=JAX_PKG)
    assert symbols(theirs) == {"compile_now:compile", "relu:if(x)"}
    mine = run_lint(root=make_tree(tmp_path / "port", PKG, files), rules=["PL01"],
                    use_baseline=False)
    assert mine.ok and not mine.findings


# -- the real tree --------------------------------------------------------------


@pytest.fixture(scope="module")
def real_raw():
    """The port's runner over the real tree, every rule, no baseline."""
    return run_lint(use_baseline=False)


def test_real_tree_findings_equal_the_jax_runners_over_the_port(real_raw):
    rules = ["PL03", "PL04", "PL05"]
    mine = run_lint(rules=rules, use_baseline=False)
    theirs = jax_run_lint(root=REPO_ROOT, rules=rules, use_baseline=False, package=PKG)
    assert rows(mine, PKG) == rows(theirs, PKG)
    assert (mine.files, mine.suppressed) == (theirs.files, theirs.suppressed)
    assert mine.files > 100
    # PL01's sub-checks 1 and 4 over the real tree: the JAX rule's
    # findings restricted to them equal the port rule's (none today)
    jax_pl01 = jax_run_lint(root=REPO_ROOT, rules=["PL01"], use_baseline=False,
                            package=PKG)
    kept = [f for f in jax_pl01.findings
            if f.symbol.startswith("jax:") or "_aot_key:" in f.symbol]
    assert [f for f in real_raw.findings if f.rule == "PL01"] == kept == []


def test_shipped_baseline_makes_the_tree_ok_with_no_stale_entry(real_raw):
    report = run_lint()
    assert report.ok, "unbaselined findings:\n" + "\n".join(
        f.render() for f in report.findings)
    assert not report.stale_baseline, report.stale_baseline
    assert sorted(RULES) == report.rules == ["PL01", "PL02", "PL03", "PL04", "PL05"]
    # --no-baseline lists exactly the baseline's entries, each with a reason
    accepted = load_baseline(REPO_ROOT / DEFAULT_BASELINE)
    assert sorted(f.key for f in real_raw.findings) == sorted(accepted)
    assert all(len(reason) > 20 for reason in accepted.values())
    assert DEFAULT_BASELINE == "conf/lint-baseline-torch.json"


def test_baseline_entry_without_reason_is_refused(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"entries": [{"key": "PL05:x:y", "reason": " "}]}))
    with pytest.raises(ValueError, match="written reason"):
        load_baseline(p)


def test_baseline_accepts_keys_and_reports_stale_entries(tmp_path):
    root = make_tree(tmp_path, PKG, {
        "{pkg}/server/h.py": """\
            def fetch(call, retry_with_backoff):
                return retry_with_backoff(call)
        """,
        DEFAULT_BASELINE: json.dumps({"entries": [
            {"key": f"PL05:{PKG}/server/h.py:fetch:retry_on",
             "reason": "fixture: deliberately unscoped"},
            {"key": f"PL05:{PKG}/server/gone.py:old:retry_on",
             "reason": "fixture: the code this covered is gone"},
        ]}),
    })
    report = run_lint(root=root, rules=["PL05"])
    assert report.ok
    assert [f.symbol for f in report.baselined] == ["fetch:retry_on"]
    assert report.stale_baseline == [f"PL05:{PKG}/server/gone.py:old:retry_on"]


def test_unknown_rule_id_is_refused(tmp_path):
    make_tree(tmp_path, PKG, {})
    with pytest.raises(ValueError, match="PL99"):
        run_lint(root=tmp_path, rules=["PL99"])


# -- PL02: the port imports no jax, its ops-box verbs no torch ------------------

_PL02_CLI = """\
    import argparse

    _TORCH_VERBS = {"train"}

    def cmd_train(args):
        import {pkg}.ops.math as m
        return 0

    def cmd_models(args):
        import {pkg}.ops.math as m
        return 0

    def cmd_index(args):
        import {pkg}.ann
        return 0

    def build_parser():
        p = argparse.ArgumentParser()
        sub = p.add_subparsers()
        a = sub.add_parser("train")
        a.set_defaults(fn=cmd_train)
        b = sub.add_parser("models")
        b.set_defaults(fn=cmd_models)
        c = sub.add_parser("index")
        c.set_defaults(fn=cmd_index)
        return p
"""

_PL02_FILES = {
    "{pkg}/ops/__init__.py": "",
    "{pkg}/ops/math.py": "import torch\n",
    "{pkg}/ann/__init__.py": """\
        def load():
            import torch  # the allowed lazy import
            return torch
    """,
    "{pkg}/tools/__init__.py": "",
    "{pkg}/tools/cli.py": _PL02_CLI,
}


def test_pl02_flags_jax_and_the_jax_package_at_any_scope(tmp_path):
    root = make_tree(tmp_path, PKG, {
        "{pkg}/models/__init__.py": "",
        "{pkg}/models/a.py": """\
            import jax
            import predictionio_tpu_torch.models  # the port itself: fine

            def lazy():
                import jax.numpy as jnp
                return jnp

            def borrowed():
                from predictionio_tpu.utils.bimap import BiMap
                return BiMap

            def dynamic(importlib):
                return importlib.import_module("optax")
        """,
        "{pkg}/models/b.py": "from flax import linen\n",
    })
    report = run_lint(root=root, rules=["PL02"], use_baseline=False)
    assert symbols(report) == {
        "module:jax", "lazy:jax.numpy", "borrowed:predictionio_tpu.utils.bimap",
        "dynamic:optax", "module:flax"}
    assert {f.path for f in report.findings} == {
        f"{PKG}/models/a.py", f"{PKG}/models/b.py"}
    assert all("the port never imports jax" in f.message for f in report.findings)


def test_pl02_flags_a_non_torch_verb_whose_closure_reaches_torch(tmp_path):
    report = run_lint(root=make_tree(tmp_path, PKG, _PL02_FILES), rules=["PL02"],
                      use_baseline=False)
    # 'models' is not in _TORCH_VERBS, so its import of ops.math (which
    # imports torch at module scope) is a violation; 'train' is exempt
    # and 'index' only reaches torch through a function-local import
    assert symbols(report) == {f"verb 'models':{PKG}.ops.math"}
    assert "reaches torch" in report.findings[0].message
    assert f"{PKG}.ops.math -> torch" in report.findings[0].message


def test_pl02_checks_the_cli_startup_closure(tmp_path):
    root = make_tree(tmp_path, PKG, dict(_PL02_FILES, **{
        "{pkg}/tools/cli.py": "    import {pkg}.ops.math\n" + _PL02_CLI}))
    report = run_lint(root=root, rules=["PL02"], use_baseline=False)
    assert f"cli-startup:{PKG}.ops.math" in symbols(report)


def test_torch_verbs_cover_the_jax_clis_jax_verbs():
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.tools import cli

    assert jax_cli._JAX_VERBS <= cli._TORCH_VERBS


# -- the CLI verb ----------------------------------------------------------------


def _cli(*argv, cwd=REPO_ROOT, prelude=""):
    code = (prelude + "import sys, runpy\n"
            f"sys.argv = ['pio', *{list(argv)!r}]\n"
            f"runpy.run_module('{PKG}.tools.cli', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(cwd), timeout=300)


def test_cli_lint_exit_codes_and_json_payload(tmp_path):
    root = make_tree(tmp_path, PKG, {"{pkg}/server/h.py": _PL05_SERVER})
    proc = _cli("lint", "--json", "--root", str(root), "--no-baseline",
                "--rule", "PL05")
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] is False and payload["rules"] == ["PL05"]
    assert {f["symbol"] for f in payload["findings"]} == {
        "fetch:retry_on", "swallow:bare-except", "throttle:retry-after"}
    assert {f["key"] for f in payload["findings"]} == {
        f"PL05:{PKG}/server/h.py:fetch:retry_on",
        f"PL05:{PKG}/server/h.py:swallow:bare-except",
        f"PL05:{PKG}/server/h.py:throttle:retry-after"}
    # the same findings through a baseline file: exit 0, text summary
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"entries": [
        {"key": f["key"], "reason": "fixture"} for f in payload["findings"]]
        + [{"key": "PL05:gone:x", "reason": "fixture: stale"}]}))
    proc = _cli("lint", "--root", str(root), "--baseline", str(base), "--rule", "PL05")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith(
        "[lint] rules=PL05 files=2 findings=0 baselined=3 suppressed=0 (")
    assert lines[1:] == [
        "[lint] warning: stale baseline entry (no longer fires): PL05:gone:x"]
    # an unknown rule id dies with the runner's message
    proc = _cli("lint", "--root", str(root), "--rule", "PL99")
    assert proc.returncode == 1
    assert proc.stderr.startswith("[error] unknown rule id(s): ['PL99']")


def test_cli_lint_over_the_real_tree_runs_with_torch_poisoned():
    """The ops-box contract: ``pio lint`` works where torch (and jax)
    cannot be imported. A meta-path finder refuses them; the real tree
    lints clean against the shipped baseline."""
    prelude = (
        "import sys\n"
        "class _Poison:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax', 'jaxlib', 'numpy'):\n"
        "            raise ImportError(name + ' is poisoned')\n"
        "sys.meta_path.insert(0, _Poison())\n")
    proc = _cli("lint", prelude=prelude)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    assert lines[0].startswith("[lint] rules=PL01,PL02,PL03,PL04,PL05 files=")
    assert " findings=0 baselined=" in lines[0]
