"""External-process engine bridge — the ``PythonEngine`` analogue.

The port of the JAX package's ``e2/external.py``, unchanged but for its
imports (the bridge runs no device work). Reference: [U] e2/.../engine/PythonEngine.scala (unverified, SURVEY.md
§2a): in 0.14 the JVM framework could host an engine whose DASE logic
ran in a forked PySpark process. Inverted here: this framework is
Python, so the bridge hosts an engine written in *any* language as a
subprocess speaking a line-JSON protocol:

    <cmd> train <train.jsonl> <model_dir>     one-shot; exit 0 = trained
    <cmd> serve <model_dir>                   long-lived; one JSON query
                                              per stdin line → one JSON
                                              prediction per stdout line

Training data is materialized to JSONL host-side (one record per line);
the external trainer owns its own compute. The serve child is spawned
lazily on first predict and kept resident — the process-level analogue
of a model held in HBM.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Any, Dict, List, Optional

from predictionio_tpu_torch.controller.base import WorkflowContext
from predictionio_tpu_torch.controller.components import Algorithm


class ExternalAlgorithm(Algorithm):
    """Runs train/serve in a subprocess. ``params``: {"command":
    [argv...], "timeout": seconds (train), "env": {...}}."""

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(params or {})
        if not self.params.get("command"):
            raise ValueError("ExternalAlgorithm needs params['command']")
        self._child: Optional[subprocess.Popen] = None
        # serializes the write+readline round-trip: the engine server
        # dispatches concurrent queries via asyncio.to_thread
        self._lock = threading.Lock()

    def _command(self) -> List[str]:
        return list(self.params["command"])

    def _env(self) -> Dict[str, str]:
        return {**os.environ, **self.params.get("env", {})}

    # -- train -----------------------------------------------------------------

    def train(self, ctx: WorkflowContext, prepared_data: Any) -> str:
        """``prepared_data``: an iterable of JSON-serializable records.
        Returns the model directory path (persisted via save_model)."""
        workdir = tempfile.mkdtemp(prefix="pio-external-")
        train_path = os.path.join(workdir, "train.jsonl")
        model_dir = os.path.join(workdir, "model")
        os.makedirs(model_dir, exist_ok=True)
        with open(train_path, "w") as f:
            for rec in prepared_data:
                f.write(json.dumps(rec) + "\n")
        proc = subprocess.run(
            self._command() + ["train", train_path, model_dir],
            env=self._env(), capture_output=True, text=True,
            timeout=self.params.get("timeout", 3600),
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"external trainer failed (rc={proc.returncode}): "
                f"{proc.stderr[-2000:]}")
        return model_dir

    # -- persistence: copy the external model dir into the instance dir --------

    def save_model(self, model: str, instance_dir: Optional[str]) -> Optional[bytes]:
        if instance_dir is None:
            raise ValueError("ExternalAlgorithm requires an instance dir")
        dest = os.path.join(instance_dir, "external_model")
        if os.path.abspath(model) != os.path.abspath(dest):
            shutil.copytree(model, dest, dirs_exist_ok=True)
            workdir = os.path.dirname(os.path.abspath(model))
            if os.path.basename(workdir).startswith("pio-external-"):
                shutil.rmtree(workdir, ignore_errors=True)
        return None

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]) -> str:
        dest = os.path.join(instance_dir or "", "external_model")
        if not os.path.isdir(dest):
            raise FileNotFoundError(f"external model dir missing: {dest}")
        return dest

    # -- serve -----------------------------------------------------------------

    def _ensure_child(self, model_dir: str) -> subprocess.Popen:
        if self._child is None or self._child.poll() is not None:
            self._child = subprocess.Popen(
                self._command() + ["serve", model_dir],
                env=self._env(), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, text=True, bufsize=1,
            )
        return self._child

    def predict(self, model: str, query: Any) -> Any:
        with self._lock:
            child = self._ensure_child(model)
            assert child.stdin is not None and child.stdout is not None
            child.stdin.write(json.dumps(query) + "\n")
            child.stdin.flush()
            line = child.stdout.readline()
        if not line:
            raise RuntimeError("external serve process closed its stdout")
        return json.loads(line)

    def close(self) -> None:
        if self._child is not None and self._child.poll() is None:
            self._child.terminate()
            try:
                self._child.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._child.kill()
                self._child.wait()  # reap — no zombie in a resident server
        self._child = None
