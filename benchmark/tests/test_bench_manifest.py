"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchlib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = common.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_check_budget_fits_with_24_cells():
    s = MAN["run_seconds"]
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_found_by_name():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert os.path.exists(common.ROOT / c["file"])
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_workloads_found_by_name():
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        wl, cfg, mix = common.cell_spec(w["name"], MAN)
        assert mix["driver"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert os.path.exists(common.BENCH / "metrics" / f"{m['name']}.py")
        for w in m.get("workloads", []):
            assert w in cells
            reported = {x["name"] for x in common.cell_metrics(w, MAN)[0]}
            assert m["moves"] in reported
    for w in cells:
        e, layer = common.cell_metrics(w, MAN)
        assert "setup_s" in {x["name"] for x in e} and len(e) >= 2 and layer
