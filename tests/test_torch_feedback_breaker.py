"""The feedback breaker counts a failed backlog as the JAX package counts
failed events: one failure an event.

The port's feedback workers send what has queued up in one call (at most
50 events). The JAX package sends, and counts through its sink breaker,
one event a call; its breaker (``failure_threshold`` 5) therefore opens
after five failed events however the queries arrive. These cases hold a
backlog of 12 events, delivered through the port's ``_record_feedback``
in ONE call, against 12 calls of the JAX package's: the breaker's state,
the sink's attempts and the feedback counters must be equal, for a sink
with ``send()`` alone and for one with ``send_batch()``.
"""

from __future__ import annotations

import pytest

from predictionio_tpu.server.engine_server import EngineServer as JaxEngineServer
from predictionio_tpu.storage.registry import Storage as JaxStorage
from predictionio_tpu.storage.registry import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch.server.engine_server import EngineServer
from predictionio_tpu_torch.storage.registry import Storage, StorageConfig
from tests.test_torch_feedback_plugins import FailingSink
from tests.test_workflow import FACTORY

N = 12


class FailingBatchSink(FailingSink):
    """A hard-down sink that also takes a backlog in one call."""

    def send_batch(self, events):
        self.attempts += 1
        raise OSError("event server unreachable")


def _counts(server) -> dict:
    return {k[0]: v for k, v in server._m_feedback.items()}


def _server(cls, storage, sink, **kw):
    return cls(engine_factory=FACTORY, storage=storage, host="127.0.0.1", port=0,
               feedback=True, event_sink=sink, require_engine=False, **kw)


def _jax_side(tmp_path, sink):
    server = _server(JaxEngineServer, JaxStorage(JaxStorageConfig(
        home=str(tmp_path / "jax"))), sink)
    before = _counts(server)
    for j in range(N):
        server._record_feedback({"user": str(j)}, {"itemScores": []}, f"pr{j}")
    return server, before


def _port_side(tmp_path, sink):
    server = _server(EngineServer, Storage(StorageConfig(home=str(tmp_path / "port"))),
                     sink, device="cpu")
    before = _counts(server)
    server._record_feedback([({"user": str(j)}, {"itemScores": []}, f"pr{j}", None,
                              None, None) for j in range(N)])
    return server, before


def _delta(server, before) -> dict:
    return {k: v - before.get(k, 0) for k, v in _counts(server).items()
            if v - before.get(k, 0)}


def test_a_backlog_to_a_send_only_sink_counts_each_event(tmp_path):
    mine, theirs = FailingSink(), FailingSink()
    port, pb = _port_side(tmp_path, mine)
    jax, jb = _jax_side(tmp_path, theirs)
    threshold = port._sink_breaker.failure_threshold
    assert threshold == jax._sink_breaker.failure_threshold == 5
    assert port._sink_breaker.state == jax._sink_breaker.state == "open"
    assert mine.attempts == theirs.attempts == threshold
    assert _delta(port, pb) == _delta(jax, jb) == {
        "error": threshold, "breaker_open": N - threshold}


def test_a_failed_batch_send_counts_each_of_its_events(tmp_path):
    sink = FailingBatchSink()
    port, pb = _port_side(tmp_path, sink)
    jax, _ = _jax_side(tmp_path, FailingSink())
    # one POST of the backlog, refused: the breaker holds 12 failures and
    # is open, as the JAX package's after its 12 calls
    assert sink.attempts == 1
    assert port._sink_breaker.state == jax._sink_breaker.state == "open"
    assert _delta(port, pb) == {"error": N}
    # the next backlog fails fast without touching the sink
    port._record_feedback([({"user": "x"}, {}, "pr-x", None, None, None)])
    assert sink.attempts == 1 and _delta(port, pb) == {"error": N, "breaker_open": 1}


@pytest.mark.parametrize("n", [1, 4])
def test_fewer_failures_than_the_threshold_keep_the_breaker_closed(tmp_path, n):
    sink = FailingSink()
    port = _server(EngineServer, Storage(StorageConfig(home=str(tmp_path))), sink,
                   device="cpu")
    before = _counts(port)
    port._record_feedback([({"user": str(j)}, {}, f"pr{j}", None, None, None)
                           for j in range(n)])
    assert port._sink_breaker.state == "closed" and sink.attempts == n
    assert _delta(port, before) == {"error": n}
