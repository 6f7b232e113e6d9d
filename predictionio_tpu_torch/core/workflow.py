"""Train and deploy workflows.

Equivalent of the reference's ``CoreWorkflow`` / ``CreateServer.prepareDeploy``
(SURVEY.md §3.1–3.2) and of the JAX package's ``core/workflow``:

- :func:`run_train` — INIT row → TRAINING → ``Engine.train`` on the
  device (mid-train checkpoints under ``train_ckpt_torch/``, resumed with
  ``resume=True``) → persist the per-algorithm model blobs → COMPLETED
  (or FAILED);
- :func:`prepare_deploy` — load the latest COMPLETED instance for (engine
  factory, variant), or a given one, rebuild its params from the
  recorded JSON, and restore each algorithm's model onto the serving
  device;
- :func:`run_evaluation` — EVALUATING row → the grid search on the
  device, serial (``MetricEvaluator``) or distributed (``core/sweep``)
  → EVALCOMPLETED (or FAILED, with the exception's text) and a
  ``leaderboard.json`` beside the row.

Engine factories resolve through an explicit table. An instance trained
by the JAX package records the JAX template's factory; importing it
would import the JAX package, so the table maps each supported factory
to the port's own template, and any other factory raises. An instance
the port trains records the JAX package's name of its template, so
either package's deploy finds it under the factory it knows.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import traceback
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineFactory,
    EngineParams,
)
from predictionio_tpu_torch.controller.base import WorkflowContext, params_to_json
from predictionio_tpu_torch.controller.evaluation import (
    Evaluation,
    MetricEvaluatorResult,
)
from predictionio_tpu_torch.storage.meta import (
    EngineInstance,
    EvaluationInstance,
    utcnow,
)
from predictionio_tpu_torch.storage.registry import Storage, get_storage
from predictionio_tpu_torch.utils.device import check_mesh, resolve_device

RECOMMENDATION_FACTORY = "predictionio_tpu_torch.templates.recommendation.engine:engine_factory"
JAX_RECOMMENDATION_FACTORY = "predictionio_tpu.templates.recommendation.engine:engine_factory"
SIMILARPRODUCT_FACTORY = "predictionio_tpu_torch.templates.similarproduct.engine:engine_factory"
JAX_SIMILARPRODUCT_FACTORY = "predictionio_tpu.templates.similarproduct.engine:engine_factory"
ECOMMERCE_FACTORY = "predictionio_tpu_torch.templates.ecommercerecommendation.engine:engine_factory"
JAX_ECOMMERCE_FACTORY = "predictionio_tpu.templates.ecommercerecommendation.engine:engine_factory"
TWOTOWER_FACTORY = "predictionio_tpu_torch.templates.twotower.engine:engine_factory"
JAX_TWOTOWER_FACTORY = "predictionio_tpu.templates.twotower.engine:engine_factory"
CLASSIFICATION_FACTORY = "predictionio_tpu_torch.templates.classification.engine:engine_factory"
JAX_CLASSIFICATION_FACTORY = "predictionio_tpu.templates.classification.engine:engine_factory"
TEXTCLASSIFICATION_FACTORY = (
    "predictionio_tpu_torch.templates.textclassification.engine:engine_factory")
JAX_TEXTCLASSIFICATION_FACTORY = (
    "predictionio_tpu.templates.textclassification.engine:engine_factory")
VANILLA_FACTORY = "predictionio_tpu_torch.templates.vanilla.engine:engine_factory"
JAX_VANILLA_FACTORY = "predictionio_tpu.templates.vanilla.engine:engine_factory"
UNIVERSAL_FACTORY = "predictionio_tpu_torch.templates.universal.engine:engine_factory"
JAX_UNIVERSAL_FACTORY = "predictionio_tpu.templates.universal.engine:engine_factory"
SEQUENTIALREC_FACTORY = "predictionio_tpu_torch.templates.sequentialrec.engine:engine_factory"
JAX_SEQUENTIALREC_FACTORY = "predictionio_tpu.templates.sequentialrec.engine:engine_factory"

#: engine factory recorded in an instance → the port's factory serving it
FACTORIES = {
    JAX_RECOMMENDATION_FACTORY: RECOMMENDATION_FACTORY,
    RECOMMENDATION_FACTORY: RECOMMENDATION_FACTORY,
    JAX_SIMILARPRODUCT_FACTORY: SIMILARPRODUCT_FACTORY,
    SIMILARPRODUCT_FACTORY: SIMILARPRODUCT_FACTORY,
    JAX_ECOMMERCE_FACTORY: ECOMMERCE_FACTORY,
    ECOMMERCE_FACTORY: ECOMMERCE_FACTORY,
    JAX_TWOTOWER_FACTORY: TWOTOWER_FACTORY,
    TWOTOWER_FACTORY: TWOTOWER_FACTORY,
    JAX_CLASSIFICATION_FACTORY: CLASSIFICATION_FACTORY,
    CLASSIFICATION_FACTORY: CLASSIFICATION_FACTORY,
    JAX_TEXTCLASSIFICATION_FACTORY: TEXTCLASSIFICATION_FACTORY,
    TEXTCLASSIFICATION_FACTORY: TEXTCLASSIFICATION_FACTORY,
    JAX_VANILLA_FACTORY: VANILLA_FACTORY,
    VANILLA_FACTORY: VANILLA_FACTORY,
    JAX_UNIVERSAL_FACTORY: UNIVERSAL_FACTORY,
    UNIVERSAL_FACTORY: UNIVERSAL_FACTORY,
    JAX_SEQUENTIALREC_FACTORY: SEQUENTIALREC_FACTORY,
    SEQUENTIALREC_FACTORY: SEQUENTIALREC_FACTORY,
}

#: the port's mid-train checkpoints, under the storage home. Never the
#: JAX package's ``train_ckpt``: its run_train wipes that directory at
#: start and at completion, and holds Orbax checkpoints the port cannot
#: read.
CKPT_DIR = "train_ckpt_torch"

def recorded_factory(port: str) -> str:
    """The factory an instance the port trains records: the JAX
    package's name of the same template, so both packages deploy it."""
    return next((f for f, p in FACTORIES.items() if p == port and f != port),
                port)


def port_factory(engine_factory: str) -> str:
    """The port's factory for ``engine_factory``; raises for a factory
    the port does not serve yet."""
    try:
        return FACTORIES[engine_factory]
    except KeyError:
        raise ValueError(
            f"engine factory {engine_factory!r} has no counterpart in "
            f"predictionio_tpu_torch; it serves: {sorted(FACTORIES)}") from None


def _ckpt_root(storage: Storage, engine_factory: str, variant_id: str) -> str:
    """The port's checkpoint directory of one (factory, variant): the
    factory as an instance records it, so the port's and the JAX
    package's name of a template resume the same run."""
    factory = recorded_factory(port_factory(engine_factory))
    safe = "".join(ch if ch.isalnum() else "_"
                   for ch in f"{factory}_{variant_id}")
    return os.path.join(storage.config.home, CKPT_DIR, safe)


def run_train(
    engine_factory: str,
    variant: Optional[Dict[str, Any]] = None,
    variant_path: Optional[str] = None,
    engine_params: Optional[EngineParams] = None,
    storage: Optional[Storage] = None,
    verbose: int = 0,
    batch: str = "",
    device=None,
    resume: bool = False,
) -> str:
    """Train and persist one engine instance on ``device`` (CUDA unless
    the caller passes ``"cpu"``; raises when there is no card and no CPU
    request); returns its id.

    Exactly one of ``variant`` / ``variant_path`` / ``engine_params``
    supplies the parameters (variant = parsed engine.json dict). The
    instance row, the params JSON and the model blob (a pickle of the
    per-algorithm blobs) are the JAX package's, so its deploy serves
    what this wrote.

    Iterative trainers checkpoint under ``<home>/train_ckpt_torch/
    <factory>_<variant>``: a fresh run clears that directory,
    ``resume=True`` (``pio train --resume``) keeps it so the trainer
    restores its newest checkpoint and continues, and a completed run
    removes it."""
    from predictionio_tpu_torch.utils import tracing

    device = resolve_device(device)
    storage = storage or get_storage()
    port = port_factory(engine_factory)
    engine = EngineFactory.create(port)
    if variant_path is not None:
        with open(variant_path, "r", encoding="utf-8") as f:
            variant = json.load(f)
    variant = variant or {}
    if engine_params is None:
        engine_params = engine.params_from_variant(variant)

    instance_id = storage.meta.new_instance_id()
    ei = EngineInstance(
        id=instance_id,
        status="INIT",
        start_time=utcnow(),
        end_time=None,
        engine_factory=recorded_factory(port),
        engine_variant=str(variant.get("id", "")),
        batch=batch or str(variant.get("description", "")),
        env={},
        mesh_conf=variant.get("meshConf") or variant.get("sparkConf") or {},
        data_source_params=json.dumps(params_to_json(engine_params.data_source_params)),
        preparator_params=json.dumps(params_to_json(engine_params.preparator_params)),
        algorithms_params=json.dumps([
            {"name": n, "params": params_to_json(p)}
            for n, p in engine_params.algorithms_params]),
        serving_params=json.dumps(params_to_json(engine_params.serving_params)),
    )
    check_mesh(ei.mesh_conf)
    storage.meta.insert_engine_instance(ei)
    ckpt_root = _ckpt_root(storage, port, ei.engine_variant)
    if not resume:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    ctx = WorkflowContext(storage=storage, device=device, verbose=verbose,
                          instance_id=instance_id, checkpoint_dir=ckpt_root)
    try:
        with tracing.root_span("train.run", engine_factory=engine_factory,
                               instance_id=instance_id):
            ei.status = "TRAINING"
            storage.meta.update_engine_instance(ei)
            models = engine.train(ctx, engine_params)
            if ctx.timings:
                ctx.log("train phases: " + ", ".join(
                    f"{k}={v:.3f}s" for k, v in ctx.timings.items()))
            with tracing.span("train.save", instance_id=instance_id,
                              algorithms=len(models)):
                instance_dir = storage.models.model_dir(instance_id)
                blobs: List[Optional[bytes]] = []
                for (name, algo), model in zip(
                        engine.make_algorithms(engine_params), models):
                    algo_dir = None
                    if instance_dir is not None:
                        algo_dir = os.path.join(instance_dir, name)
                        os.makedirs(algo_dir, exist_ok=True)
                    blobs.append(algo.save_model(model, algo_dir))
                storage.models.put(instance_id, pickle.dumps(blobs))
            ei.status = "COMPLETED"
            ei.end_time = utcnow()
            storage.meta.update_engine_instance(ei)
            # the run completed: its mid-train checkpoints are consumed
            shutil.rmtree(ckpt_root, ignore_errors=True)
            return instance_id
    except Exception:
        ei.status = "FAILED"
        ei.end_time = utcnow()
        storage.meta.update_engine_instance(ei)
        traceback.print_exc()
        raise


@dataclass
class DeployedEngine:
    """A trained engine loaded for serving: the resident-model bundle."""

    engine: Engine
    engine_params: EngineParams
    algorithms: List[Tuple[str, Any]]  # (name, Algorithm instance)
    models: List[Any]
    serving: Any
    instance: EngineInstance

    def query(self, query: Any) -> Any:
        q = self.serving.supplement(query)
        preds = [algo.predict(model, q)
                 for (_, algo), model in zip(self.algorithms, self.models)]
        return self.serving.serve(q, preds)

    def batch_query(self, queries: Sequence[Any]) -> List[Any]:
        """Answer a batch; AOT-bucket ``PAD`` sentinels pass through
        untouched: pad slots are never supplemented or served and come
        back as PAD so the batcher can slice them off. Algorithms that
        batch onto the device (``accepts_padding``) see the padded list
        inline; per-query algorithms only ever see real queries."""
        from predictionio_tpu_torch.server.aot import PAD, is_pad

        qs = [q if is_pad(q) else self.serving.supplement(q)
              for q in queries]
        real = [q for q in qs if not is_pad(q)]
        per_algo = []
        for (_, algo), model in zip(self.algorithms, self.models):
            if getattr(algo, "accepts_padding", False) or len(real) == len(qs):
                per_algo.append(algo.batch_predict(model, qs))
            else:
                preds = algo.batch_predict(model, real)
                it = iter(preds)
                per_algo.append(
                    [None if is_pad(q) else next(it) for q in qs])
        return [
            PAD if is_pad(q)
            else self.serving.serve(q, [preds[i] for preds in per_algo])
            for i, q in enumerate(qs)
        ]


def _latest_completed(storage: Storage, engine_factory: str,
                      variant_id: str) -> Optional[EngineInstance]:
    """Newest COMPLETED instance among every factory the same port
    template serves (an instance either package trained)."""
    target = port_factory(engine_factory)
    found = [storage.meta.get_latest_completed_engine_instance(f, variant_id)
             for f, port in FACTORIES.items() if port == target]
    found = [ei for ei in found if ei is not None]
    return max(found, key=lambda ei: ei.start_time) if found else None


def prepare_deploy(
    engine_factory: Optional[str] = None,
    instance_id: Optional[str] = None,
    storage: Optional[Storage] = None,
    variant_id: str = "",
    device=None,
) -> DeployedEngine:
    """Load the latest COMPLETED instance (or a specific one) for serving
    on ``device`` (CUDA unless the caller passes ``"cpu"``; raises when
    there is no card and no CPU request)."""
    device = resolve_device(device)
    storage = storage or get_storage()
    if instance_id is not None:
        ei = storage.meta.get_engine_instance(instance_id)
        if ei is None:
            raise ValueError(f"engine instance {instance_id!r} not found")
    else:
        if engine_factory is None:
            raise ValueError("need engine_factory or instance_id")
        ei = _latest_completed(storage, engine_factory, variant_id)
        if ei is None:
            raise ValueError(
                f"no COMPLETED engine instance for {engine_factory!r}; "
                "run `pio train` first")

    engine = EngineFactory.create(port_factory(ei.engine_factory))
    # Rebuild EngineParams from the instance's recorded JSON
    variant = {
        "datasource": {"params": json.loads(ei.data_source_params)},
        "preparator": {"params": json.loads(ei.preparator_params)},
        "algorithms": json.loads(ei.algorithms_params),
        "serving": {"params": json.loads(ei.serving_params)},
    }
    engine_params = engine.params_from_variant(variant)
    algorithms = engine.make_algorithms(engine_params)

    raw = storage.models.get(ei.id)
    if raw is None:
        raise ValueError(f"no model blob for instance {ei.id}")
    blobs: List[Optional[bytes]] = pickle.loads(raw)
    instance_dir = storage.models.model_dir(ei.id)
    models = []
    for (name, algo), blob in zip(algorithms, blobs):
        algo_dir = os.path.join(instance_dir, name) if instance_dir else None
        algo.set_serving_context(storage, device)
        models.append(algo.load_model(blob, algo_dir))
    serving = engine.serving_cls(engine_params.serving_params)
    return DeployedEngine(
        engine=engine, engine_params=engine_params, algorithms=algorithms,
        models=models, serving=serving, instance=ei)


def run_evaluation(
    evaluation: Evaluation,
    candidates: Sequence[EngineParams],
    storage: Optional[Storage] = None,
    verbose: int = 0,
    evaluation_class: str = "",
    generator_class: str = "",
    distributed: bool = False,
    sweep_shards: int = 0,
    device=None,
) -> Tuple[str, MetricEvaluatorResult]:
    """Grid-search evaluation on ``device`` (CUDA unless the caller passes
    "cpu"; raises when there is no card and no CPU request). Persists an
    EvaluationInstance row (reference: EvaluationWorkflow, SURVEY.md
    §3.4) and a versioned ``leaderboard.json`` next to it
    (``storage/leaderboard.py``), as the JAX package does.

    ``distributed=True`` routes the grid through ``core/sweep.py``:
    candidates bucketed by geometry, each bucket's sub-grid one sweep
    program that trains and scores on the device, instead of a
    per-candidate train and a per-query scoring loop. Rankings equal the
    serial path's; groups the sweep can't stack fall back to it.
    """
    device = resolve_device(device)
    storage = storage or get_storage()
    instance_id = storage.meta.new_instance_id()
    vi = EvaluationInstance(
        id=instance_id, status="EVALUATING", start_time=utcnow(), end_time=None,
        evaluation_class=evaluation_class or type(evaluation).__name__,
        engine_params_generator_class=generator_class,
        batch="", env={},
    )
    storage.meta.insert_evaluation_instance(vi)
    ctx = WorkflowContext(storage=storage, device=device, verbose=verbose,
                          instance_id=instance_id)
    try:
        if evaluation.metric is None:
            raise ValueError("Evaluation.metric not set")
        sweep_stats = None
        fold_scores = None
        if distributed:
            from predictionio_tpu_torch.core.sweep import run_sweep

            sres = run_sweep(
                ctx, evaluation.get_engine(), candidates,
                evaluation.metric, evaluation.other_metrics,
                sweep_shards=sweep_shards)
            result = sres.result
            sweep_stats = sres.stats()
            fold_scores = sres.fold_scores
        else:
            result = evaluation.run(ctx, candidates)
        vi.status = "EVALCOMPLETED"
        vi.end_time = utcnow()
        vi.evaluator_results = (
            f"best {evaluation.metric.header} = {result.best_score:.6f} "
            f"(candidate {result.best_index} of {len(result.candidates)})")
        vi.evaluator_results_json = result.to_json()
        storage.meta.update_evaluation_instance(vi)
        _write_leaderboard(storage, instance_id, evaluation.metric, result,
                           fold_scores=fold_scores, sweep_stats=sweep_stats,
                           distributed=distributed)
        return instance_id, result
    except Exception as e:
        vi.status = "FAILED"
        vi.end_time = utcnow()
        # record WHY: `pio evals show` explains a dead sweep from its row
        vi.evaluator_results = f"{type(e).__name__}: {e}"
        storage.meta.update_evaluation_instance(vi)
        raise


def _write_leaderboard(storage: Storage, instance_id: str, metric,
                       result: MetricEvaluatorResult,
                       fold_scores=None, sweep_stats=None,
                       distributed: bool = False) -> Optional[str]:
    """Persist the versioned leaderboard artifact for this evaluation
    under ``<home>/leaderboards/<instance_id>.json``. Best-effort: a
    leaderboard write failure must not fail a completed evaluation."""
    from predictionio_tpu_torch.storage import leaderboard as lb

    try:
        ep_rows = json.loads(result.to_json())["candidates"]
        doc = lb.build(
            instance_id, metric.header, bool(metric.higher_is_better),
            [row["engineParams"] for row in ep_rows],
            [s for _, s, _ in result.candidates],
            fold_scores=fold_scores,
            mode="distributed" if distributed else "serial",
            stats=sweep_stats)
        return lb.write(storage.config.home, doc)
    except Exception as e:  # a completed evaluation stays completed
        warnings.warn(f"leaderboard write failed: {e}", RuntimeWarning)
        return None
