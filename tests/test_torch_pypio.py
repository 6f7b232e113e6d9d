"""The port's ``pypio`` bridge against the repo's JAX-side ``pypio`` on twin
homes (the cases of ``tests/test_pypio.py``): the same DataFrames, the
model hand-off round trip, the cleanup hooks and event compaction; and
importing the bridge needs neither pandas nor anything of the JAX side."""

from __future__ import annotations

import datetime as dt
import os
import subprocess
import sys

import pandas as pd
import pytest

import pypio as jax_pypio
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch import pypio
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _events(cls):
    return [
        cls(event="rate", entity_type="user", entity_id="u1",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": 4.0}, event_time=T0),
        cls(event="buy", entity_type="user", entity_id="u2",
            target_entity_type="item", target_entity_id="i2",
            event_time=T0 + dt.timedelta(hours=1)),
        cls(event="$set", entity_type="user", entity_id="u1",
            properties={"plan": "pro"}, event_time=T0),
        cls(event="$set", entity_type="user", entity_id="u1",
            properties={"plan": "free"}, event_time=T0 + dt.timedelta(days=1)),
        cls(event="$set", entity_type="user", entity_id="u3",
            properties={"plan": "pro", "seats": 3}, event_time=T0),
    ]


@pytest.fixture()
def bridges(tmp_path):
    """(port bridge, JAX bridge), each bound to its twin home."""
    for mod, storage, cls in (
            (pypio, Storage(StorageConfig(home=str(tmp_path / "port"))), Event),
            (jax_pypio, JaxStorage(JaxStorageConfig(home=str(tmp_path / "jax"))),
             JaxEvent)):
        app = storage.meta.create_app("PyApp", "")
        storage.events.init_channel(app.id)
        storage.events.insert_batch(_events(cls), app.id)
        mod.init(storage)
    yield pypio, jax_pypio
    pypio.stop()
    jax_pypio.stop()


def _frame(df):
    # event ids are minted per home
    return df.drop(columns=["eventId"]).reset_index(drop=True)


@pytest.mark.parametrize("kw", [{}, {"event_names": ["buy"]}, {"entity_id": "u1"},
                                {"entity_type": "user", "event_names": ["$set"]},
                                {"start_time": T0 + dt.timedelta(minutes=1)}])
def test_find_events_gives_the_jax_bridges_dataframe(bridges, kw):
    mine, theirs = (b.find_events("PyApp", **kw) for b in bridges)
    assert list(mine.columns) == list(theirs.columns)
    assert len(mine) == len(theirs) > 0
    pd.testing.assert_frame_equal(_frame(mine), _frame(theirs))
    assert mine.eventId.map(type).eq(str).all()


def test_aggregate_properties_gives_the_jax_bridges_dataframe(bridges):
    mine, theirs = (b.data.PEventStore.aggregate_properties("PyApp", "user")
                    for b in bridges)
    pd.testing.assert_frame_equal(mine.sort_index(), theirs.sort_index())
    assert mine.loc["u1", "plan"] == "free"  # the later $set wins the fold


def test_model_round_trip_and_the_workflow_blob_refusal(bridges):
    for b in bridges:
        b.save_model({"w": [1, 2, 3]}, "inst-1", algorithm="nb")
        b.save_model("lr-model", "inst-1", algorithm="lr")
        assert b.load_model("inst-1", algorithm="nb") == {"w": [1, 2, 3]}
        assert b.load_model("inst-1", algorithm="lr") == "lr-model"
        with pytest.raises(KeyError, match="no model for engine instance"):
            b.load_model("missing")
        b.pypio._st().models.put("trained", __import__("pickle").dumps([b"blob"]))
        with pytest.raises(ValueError, match="trained by the workflow"):
            b.save_model("x", "trained")
        with pytest.raises(ValueError, match="trained by the workflow"):
            b.load_model("trained")
    # the same pickled blob in both homes
    assert (pypio.pypio._st().models.get("inst-1")
            == jax_pypio.pypio._st().models.get("inst-1"))


def test_cleanup_functions_and_clean_events(bridges):
    from predictionio_tpu_torch.pypio.workflow import CleanupFunctions

    calls = []
    CleanupFunctions.clear()
    CleanupFunctions.add(lambda: calls.append(1))
    CleanupFunctions.add(lambda: calls.append(2))
    CleanupFunctions.run()
    assert calls == [1, 2]
    CleanupFunctions.clear()
    mine, theirs = (b.workflow.clean_events("PyApp", keep_days=30000) for b in bridges)
    assert mine == theirs and mine["kept"] >= 1


def test_utils_equal_the_jax_bridges():
    for value in (None, 0, 1.5e9, "2026-01-01T00:00:00Z", "2026-01-01T03:00:00+02:00",
                  "2026-01-01T00:00:00", T0):
        assert pypio.utils.to_datetime(value) == jax_pypio.utils.to_datetime(value)
    assert pypio.utils.new_string_array([1, "a"]) == \
        jax_pypio.utils.new_string_array([1, "a"]) == ["1", "a"]


def test_importing_the_bridge_loads_no_pandas_and_nothing_of_the_jax_side():
    code = ("import sys\n"
            "import predictionio_tpu_torch.pypio as p\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pandas', 'jax', 'pypio') or m.startswith('predictionio_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
