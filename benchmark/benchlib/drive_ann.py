"""The two-tower ANN batch cell: ``pio batchpredict``
(``core/batchpredict.run_batch_predict``) over a deployed two-tower
engine whose PQ index the port builds in set-up.

Set-up makes the item embeddings and the user tower's weights on the
card from the seed, computes the user table with the port's load-time
tower (``models/two_tower.two_tower_embed_users``), builds the index
with ``ann/index.build_index`` (timed, synchronised, as ``ann_build_s``)
and assembles the template's model and a ``DeployedEngine`` in memory:
writing the 1.4 GB instance through the storage layer would write that
much disk in every run.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import time
from unittest import mock

import numpy as np

from benchlib import traffic, work
from benchlib.common import RUN_DIR, log
from benchlib.tracing import span


class BatchPredict:
    """``pio batchpredict`` over a stream of seeded queries, in the
    verb's batches; the window ends with the first batch that finishes
    after ``seconds``. The output lines go to a file in the run
    directory and are read back once the window has closed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, clock,
                 control: bool = False) -> None:
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.clock, self.control = clock, control
        self.answers = []   # (user row, [item rows], [scores])
        self._restore = contextlib.ExitStack()

    # -- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        import torch

        from predictionio_tpu_torch.core import batchpredict
        from predictionio_tpu_torch.core.workflow import DeployedEngine
        from predictionio_tpu_torch.models import two_tower
        from predictionio_tpu_torch.storage.meta import EngineInstance
        from predictionio_tpu_torch.templates.twotower import engine as tt
        from predictionio_tpu_torch.utils.bimap import BiMap

        c, dev = self.cfg, self.device
        a = c["algorithm"]
        t = time.perf_counter()
        V = traffic.catalog(torch, c["num_items"], a["out_dim"], self.seed, dev)
        self.V = V.cpu().numpy()
        del V
        self.user_vars = traffic.tower_weights(torch, c["num_users"], a["embed_dim"],
                                               a["hidden"], a["out_dim"], self.seed, dev)
        self.clock.stage("embeddings and tower weights", t)
        if self.control:
            self._control_on(two_tower)
        tp = two_tower.TwoTowerParams(embed_dim=a["embed_dim"], hidden=list(a["hidden"]),
                                      out_dim=a["out_dim"], seed=0)
        t = time.perf_counter()
        user_embeds = two_tower.two_tower_embed_users(self.user_vars, c["num_users"], tp)
        self.clock.stage("user table (two_tower_embed_users)", t)
        t = time.perf_counter()
        index = two_tower.two_tower_build_index(
            self.V, m=a["annM"], k=a["annK"], iters=a["annIters"], seed=self.seed,
            sample=a["annSample"], opq=a["annOpq"], device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.ann_build_s = self.clock.stage("index (build_index)", t)
        t = time.perf_counter()
        user_ids = BiMap({f"u{j}": j for j in range(c["num_users"])})
        item_ids = BiMap({f"i{j}": j for j in range(c["num_items"])})
        self.clock.stage("id maps", t)
        t = time.perf_counter()
        engine = tt.engine_factory()
        variant = {"algorithms": [{"name": "twotower", "params": {
            "embedDim": a["embed_dim"], "outDim": a["out_dim"], "hidden": a["hidden"],
            "ann": True, "annM": a["annM"], "annK": a["annK"], "annIters": a["annIters"],
            "annShortlist": a["annShortlist"], "annSample": a["annSample"],
            "annOpq": a["annOpq"]}}]}
        params = engine.params_from_variant(variant)
        algorithms = engine.make_algorithms(params)
        for _, algo in algorithms:
            algo.set_serving_context(None, dev)
        ap = algorithms[0][1].params
        self.model = tt.TwoTowerModel(self.user_vars, self.V, user_ids, item_ids, tp,
                                      user_embeds=user_embeds, ann_index=index,
                                      ann_shortlist=ap.ann_shortlist,
                                      ann_shards=ap.ann_shards, device=dev)
        now = _dt.datetime.now(_dt.timezone.utc)
        instance = EngineInstance(
            id="benchmark", status="COMPLETED", start_time=now, end_time=now,
            engine_factory="predictionio_tpu_torch.templates.twotower.engine:engine_factory",
            engine_variant="benchmark", batch="", env={}, mesh_conf={},
            data_source_params="{}", preparator_params="{}",
            algorithms_params=json.dumps(variant["algorithms"]), serving_params="{}")
        self.deployed = DeployedEngine(engine=engine, engine_params=params,
                                       algorithms=algorithms, models=[self.model],
                                       serving=engine.serving_cls(params.serving_params),
                                       instance=instance)
        self.model._device_scorer()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.clock.stage("deployed engine (scorer placed)", t)
        self.law = traffic.UserLaw(self.mix["users"], c["num_users"], self.seed)
        self.num = int(self.mix["num"])
        self.B = int(self.mix.get("batch", batchpredict.BATCH))
        t = time.perf_counter()
        src = traffic.query_lines(self.law, self.num, self.B)
        with open(RUN_DIR / "warmup.jsonl", "w") as out:
            batchpredict.run_batch_predict(self.deployed, (next(src) for _ in range(self.B)),
                                           out, batch_size=self.B)
        self.clock.stage("warm-up batch", t)

    def _control_on(self, two_tower) -> None:
        """The control: the program's own TF32 path (its float32 guard
        taken out, TF32 allowed for every float32 product: the index
        build, the scan and the re-rank) and the reference's tower in
        TF32 in the program's place."""
        import torch

        from predictionio_tpu_torch.utils import device as pdevice

        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        self._restore.callback(torch.set_float32_matmul_precision, prev)
        self._restore.enter_context(
            mock.patch.object(pdevice, "full_f32", contextlib.nullcontext))
        dev = self.device

        def tf32_tower(variables, n_users, params, chunk=65536):
            out = []
            for lo in range(0, n_users, chunk):
                ids = np.arange(lo, min(lo + chunk, n_users))
                p32 = {"params": {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                                  for k, d in variables["params"].items()}}
                with torch.no_grad():
                    out.append(_tower32(p32, ids, dev).cpu().numpy())
            return np.concatenate(out)

        self._restore.enter_context(
            mock.patch.object(two_tower, "two_tower_embed_users", tf32_tower))

    # -- the window --------------------------------------------------------------

    def run_window(self, seconds: float) -> None:
        from predictionio_tpu_torch.core.batchpredict import run_batch_predict

        src = traffic.query_lines(self.law, self.num, self.B)
        path = RUN_DIR / "predictions.jsonl"
        t0 = time.perf_counter()
        deadline = t0 + seconds
        B = self.B

        def lines():
            for j, line in enumerate(src):
                if j % B == 0 and j and time.perf_counter() >= deadline:
                    return
                yield line

        with open(path, "w") as out, span("window"):
            self.n = run_batch_predict(self.deployed, lines(), out, batch_size=B)
        self.window_s = time.perf_counter() - t0
        self.batches = self.n // B
        with open(path) as f:
            for line in f:
                doc = json.loads(line)
                scores = doc["prediction"].get("itemScores", [])
                self.answers.append((int(doc["query"]["user"][1:]),
                                     [int(s["item"][1:]) for s in scores],
                                     [float(s["score"]) for s in scores]))

    def end_to_end(self) -> dict:
        return {"predictions_per_s": self.n / self.window_s}

    @property
    def attempted(self) -> int:
        return self.n

    @property
    def failed(self) -> int:
        """Queries whose line is missing or holds another number of items."""
        return sum(len(items) != self.num for _, items, _ in self.answers) \
            + self.n - len(self.answers)

    def layer_context(self) -> dict:
        a = self.cfg["algorithm"]
        k = 16
        while k < self.num:
            k *= 2
        return {"kind": "ann_batch",
                "ann_bound_s": work.dispatch_work(
                    {self.B: self.batches}, self.cfg["num_items"], a["annM"], a["annK"],
                    a["out_dim"], a["annShortlist"], k),
                "ann_build_s": self.ann_build_s}

    # -- the check -------------------------------------------------------------------

    def release(self) -> None:
        import torch

        self._restore.close()
        self.index = self.model.ann_index
        self.user_embeds = self.model.user_embeds
        self.model._scorer = None
        self.deployed = None
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The index's codebooks against the reference's float64 Lloyd
        from the same seeded sample and starting centroids: the median
        centroid's largest difference, over the codebooks' largest entry
        (``centroid_err``; the median, since a near-tie that float32
        assigns the other way moves a few centroids by 1e-3 and more);
        the index's codes of a seeded sample of items against the nearest
        centroid in float64 (``code_faults``); the program's user table
        against the reference's tower for the sampled users
        (``tower_err``); and a sample drawn from the seed of the window's
        answers: the largest distance of a served score from the float64
        score of its item under the reference's query (``score_err``),
        and the answers that a float64 replay over the program's index
        from the program's query finds a fault in that no float32
        rounding explains (``answer_faults``, ``reference/twotower.judge``)."""
        import torch

        from reference import twotower as ref

        t = time.perf_counter()
        dev, lim, a = self.device, self.cfg["checks"], self.cfg["algorithm"]
        cb_ref = ref.lloyd64(self.V, a["annM"], a["annK"], a["annIters"], self.seed,
                             a["annSample"], dev)
        cb_got = torch.as_tensor(self.index.codebooks, device=dev).to(ref.F64)
        per = (cb_got - cb_ref).abs().amax(-1) / cb_ref.abs().max()
        centroid_err, centroid_max = float(per.median()), float(per.max())
        del cb_ref
        rng = np.random.default_rng([self.seed, 5])
        n = min(len(self.answers), int(self.cfg["check_answers"]))
        pick = rng.choice(len(self.answers), size=n, replace=False) if n else []
        sample = [self.answers[i] for i in pick]
        idx = ref.Index(self.index.codebooks, self.index.codes, dev)
        users = np.asarray([u for u, _, _ in sample], np.int64)
        q_ref = ref.tower64(self.user_vars, users, dev)
        q_prog = torch.as_tensor(self.user_embeds[users], device=dev).to(ref.F64)
        tower_err = float((q_prog - q_ref).abs().max()) if n else float("inf")
        V64 = _Rows(torch.as_tensor(self.V, device=dev))
        score_err = 0.0 if n else float("inf")
        bad = 0 if n else 1
        kprime = int(a["annShortlist"])
        for (u, items, scores), q, q64 in zip(sample, q_prog, q_ref):
            f, _, _ = ref.judge(items, scores, q, V64, ref.Replay(q, idx, kprime), self.num)
            bad += f > 0
            exact = [float(V64[j] @ q64) for j in items]
            score_err = max([score_err] + [abs(s - e) for s, e in zip(scores, exact)])
        rows = rng.choice(self.index.n_items, size=min(self.index.n_items,
                                                      int(self.cfg["check_codes"])),
                          replace=False)
        code_faults = ref.nearest_codes_miss(
            torch.as_tensor(self.V[rows], device=dev),
            torch.as_tensor(self.index.codes[rows], device=dev), idx)
        log(f"check: the median centroid off the float64 Lloyd's by {centroid_err:.3e} (the "
            f"farthest {centroid_max:.3e}); {n} answers "
            f"replayed ({bad} with a fault; widest score error {score_err:.3e}), "
            f"{len(rows)} codes checked, in {time.perf_counter() - t:.1f} s")
        return {"centroid_err": (centroid_err, lim["centroid_err"]),
                "code_faults": (code_faults, 0),
                "tower_err": (tower_err, lim["tower_err"]),
                "score_err": (score_err, lim["score_err"]),
                "answer_faults": (bad, 0)}


class _Rows:
    """Float64 rows of a float32 table on the device, made when read."""

    def __init__(self, V) -> None:
        self.V = V

    def __getitem__(self, j):
        import torch

        return self.V[j].to(torch.float64)


def _tower32(params: dict, ids, device):
    """The user tower in float32 torch products (TF32 when the process
    allows it): the control's tower."""
    import torch

    p = params["params"]
    x = torch.as_tensor(p["Embed_0"]["embedding"], device=device)[
        torch.as_tensor(ids, device=device).long()]
    names = sorted((k for k in p if k.startswith("Dense_")), key=lambda k: int(k.split("_")[1]))
    for j, n in enumerate(names):
        x = x @ torch.as_tensor(p[n]["kernel"], device=device) \
            + torch.as_tensor(p[n]["bias"], device=device)
        if j < len(names) - 1:
            x = torch.relu(x)
    return x / (1e-8 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))
