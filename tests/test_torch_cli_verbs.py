"""The last verbs of the port's CLI (``version``, ``undeploy``,
``template list|new``, ``build``, ``run``, ``shell``) and ``fake_run``,
held against the JAX CLI and the JAX package's ``core/fake_workflow``
on twin temporary homes."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

from predictionio_tpu.core.fake_workflow import fake_run as jax_fake_run
from predictionio_tpu.storage import registry as jax_registry
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu.templates import TEMPLATES as JAX_TEMPLATES
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.version import __version__ as jax_version
from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.core.fake_workflow import fake_run
from predictionio_tpu_torch.storage import registry as port_registry
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from predictionio_tpu_torch.templates import TEMPLATES
from predictionio_tpu_torch.tools import cli
from tests.test_torch_cli import Twins, _run
from tests.test_torch_event_server import ServerThread
from tests.test_torch_ops_surface import sides, trained  # noqa: F401 (fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tmpl_dir(pkg: str, name: str) -> str:
    return os.path.join(REPO, pkg, "templates", name)


@pytest.fixture()
def twins(tmp_path, capsys):
    return Twins(tmp_path, capsys)


def _subparsers(parser):
    import argparse

    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def test_the_ports_parser_has_every_verb_of_the_jax_parser():
    jax_verbs = _subparsers(jax_cli.build_parser())
    port_verbs = _subparsers(cli.build_parser())
    assert "lint" in jax_verbs
    assert set(jax_verbs) <= set(port_verbs), set(jax_verbs) - set(port_verbs)
    # lint takes the JAX verb's flags
    def flags(p):
        return sorted(s for a in p._actions for s in a.option_strings)
    assert flags(port_verbs["lint"]) == flags(jax_verbs["lint"])


def test_version_and_the_version_flag(twins):
    assert __version__ == jax_version
    assert twins.run("version") == (0, [__version__], [])
    assert twins.run("--version") == (0, [__version__], [])


def test_template_list_names_the_jax_registrys_templates(twins, capsys):
    assert list(TEMPLATES) == list(JAX_TEMPLATES)
    for name, mod in TEMPLATES.items():
        assert mod == JAX_TEMPLATES[name].replace("predictionio_tpu.",
                                                  "predictionio_tpu_torch.", 1)
    code, lines, _ = _run(cli.main, port_registry, Storage(StorageConfig(
        home=twins.homes["port"])), ["template", "list"], capsys)
    jcode, jlines, _ = _run(jax_cli.main, jax_registry, JaxStorage(JaxStorageConfig(
        home=twins.homes["jax"])), ["template", "list"], capsys)
    assert code == jcode == 0
    assert lines == [f"{n:<26} {m}" for n, m in TEMPLATES.items()]
    assert [line.split()[0] for line in lines] == [line.split()[0] for line in jlines]


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_template_new_copies_each_packages_engine_json(twins, name):
    code, lines, err = twins.run("template", "new", name, "{home}/engine")
    assert code == 0 and err == []
    assert lines == [f"[info] Created engine dir {{home}}/engine from template "
                     f"{name!r}. Edit {{home}}/engine/engine.json (set appName) "
                     "and run `pio train`."]
    for pkg, side in (("predictionio_tpu", "jax"), ("predictionio_tpu_torch", "port")):
        with open(os.path.join(twins.homes[side], "engine", "engine.json"), "rb") as f:
            made = f.read()
        src = os.path.join(_tmpl_dir(pkg, name), "engine.json")
        if os.path.exists(src):
            with open(src, "rb") as f:
                assert made == f.read()
        else:  # no engine.json in the template: a minimal variant
            assert json.loads(made) == {"id": "default", "engineFactory":
                                        f"{pkg}.templates.{name}.engine:engine_factory"}
    assert twins.run("template", "new", "nope", "{home}/x")[0] == 1


def test_build_validates_an_engine_dir_like_the_jax_cli(twins, tmp_path):
    # the JAX template's own engine.json: both CLIs accept it alike
    out = twins.run("build", "--engine-dir", _tmpl_dir("predictionio_tpu", "recommendation"))
    assert out == (0, ["[info] Engine predictionio_tpu.templates.recommendation.engine:"
                       "engine_factory is valid. Ready for `pio train`."], [])
    code, lines, _ = _run(cli.main, port_registry, Storage(StorageConfig(
        home=twins.homes["port"])), ["build", "--engine-dir",
                                     _tmpl_dir("predictionio_tpu_torch", "recommendation")],
        twins.capsys)
    assert code == 0 and lines == [
        "[info] Engine predictionio_tpu_torch.templates.recommendation.engine:"
        "engine_factory is valid. Ready for `pio train`."]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"engineFactory": "predictionio_tpu.templates."
                               "recommendation.engine:engine_factory",
                               "algorithms": [{"name": "als", "params": {"nope": 1}}]}))
    for main, registry, storage in (
            (cli.main, port_registry, Storage(StorageConfig(home=twins.homes["port"]))),
            (jax_cli.main, jax_registry, JaxStorage(JaxStorageConfig(
                home=twins.homes["jax"])))):
        code, _, err = _run(main, registry, storage,
                            ["build", "--engine-dir", str(tmp_path), "-e", str(bad)],
                            twins.capsys)
        assert code == 1 and err[0].startswith("[error] engine validation failed: "
                                               "unknown parameter 'nope'")
    assert twins.run("build", "--engine-dir", str(tmp_path / "none"))[0] == 1


def test_run_calls_a_callable_from_the_engine_dir(twins, tmp_path):
    (tmp_path / "pio_cli_verbs_main.py").write_text(
        "def main(*args):\n    return '-'.join(args) or None\n")
    assert twins.run("run", "pio_cli_verbs_main:main", "a", "b",
                     "--engine-dir", str(tmp_path)) == (0, ["a-b"], [])
    assert twins.run("run", "pio_cli_verbs_main:main",
                     "--engine-dir", str(tmp_path)) == (0, [], [])


def test_undeploy_stops_a_running_engine_server(trained, capsys):  # noqa: F811
    outs = {}
    for side in trained:
        server = ServerThread(side.engine())
        server.__enter__()
        main, registry = ((jax_cli.main, jax_registry) if side.name == "jax"
                          else (cli.main, port_registry))
        outs[side.name] = _run(main, registry, side.storage,
                               ["undeploy", "--ip", "127.0.0.1", "--port",
                                str(server.port)], capsys)
        server.thread.join(timeout=30)
        assert not server.thread.is_alive(), f"{side.name} server still running"
        server.loop.close()
        # nothing listens on the port any more
        with pytest.raises(ConnectionRefusedError):
            socket.create_connection(("127.0.0.1", server.port), timeout=5).close()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == 0 and json.loads(outs["torch"][1][0]) == {
        "message": "Shutting down"}


def test_shell_preloads_the_ports_storage_store_and_pypio(tmp_path):
    port_registry.set_storage(Storage(StorageConfig(home=str(tmp_path))))
    try:
        ns = cli.shell_namespace()
    finally:
        port_registry.set_storage(None)
    assert sorted(ns) == ["predictionio_tpu_torch", "pypio", "storage", "store"]
    assert ns["pypio"].pypio._st() is ns["storage"]
    assert ns["store"].__name__ == "predictionio_tpu_torch.data.store"
    ns["pypio"].stop()
    # the verb itself: a prompt on stdin, nothing of the JAX package loaded
    script = ("import sys\n"
              "print('LOADED', type(storage).__module__, pypio.__name__, "
              "sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
              "or m.startswith('predictionio_tpu.') or m == 'pandas'))\n")
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "shell"],
        input=script, cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PIO_HOME=str(tmp_path / "home"), PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert f"predictionio_tpu_torch {__version__} shell" in proc.stderr
    assert ("LOADED predictionio_tpu_torch.storage.registry "
            "predictionio_tpu_torch.pypio []") in proc.stdout


def _rows(storage):
    return [(ei.status, ei.engine_factory, ei.engine_variant, ei.batch, ei.mesh_conf,
             ei.end_time is not None)
            for ei in storage.meta.list_engine_instances()]


def test_fake_run_brackets_a_function_like_the_jax_package(tmp_path):
    mine = Storage(StorageConfig(home=str(tmp_path / "port")))
    theirs = JaxStorage(JaxStorageConfig(home=str(tmp_path / "jax")))
    seen = {}

    def fn(ctx):
        seen["status"] = ctx.storage.meta.get_engine_instance(ctx.instance_id).status
        seen["mesh"] = ctx.mesh
        return 42

    assert fake_run(fn, storage=mine, label="probe", device="cpu") == 42
    assert seen == {"status": "TRAINING", "mesh": None}
    assert jax_fake_run(fn, storage=theirs, label="probe") == 42
    assert fake_run(fn, storage=mine, use_mesh=True, device="cpu") == 42
    assert seen["mesh"].size == 1 and seen["mesh"].axis_names == ("data",)

    def boom(ctx):
        raise RuntimeError("fake failure")

    for run, st in ((fake_run, mine), (jax_fake_run, theirs)):
        with pytest.raises(RuntimeError, match="fake failure"):
            run(boom, storage=st, label="boom",
                **({"device": "cpu"} if run is fake_run else {}))
    assert sorted(_rows(mine)) == sorted(_rows(theirs) + [
        ("COMPLETED", "fake:fake", "", "fake", {}, True)])
    assert ("COMPLETED", "fake:probe", "", "probe", {}, True) in _rows(mine)
    assert ("FAILED", "fake:boom", "", "boom", {}, True) in _rows(mine)
