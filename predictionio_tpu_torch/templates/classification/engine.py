"""Classification template: NaiveBayes / LogisticRegression / RandomForest.

The port of the JAX package's template of the same path (the reference's
classification template: ``$set`` user properties ``attr0..attrN`` plus
an integer label, MLlib NaiveBayes, LogisticRegressionWithLBFGS and
RandomForest). Wire shapes preserved:

    POST /queries.json  {"attr0": 2.0, "attr1": 0.0, "attr2": 0.0}
    → {"label": 0.0}

Training runs on the training device (CUDA unless the caller asks for the
CPU) through :mod:`predictionio_tpu_torch.models.naive_bayes`,
``.linear`` and ``.forest``; serving scores one query in host numpy, as
the JAX package does. ``run_train`` refuses a ``meshConf`` asking for
more than one device. The model blob pickles :class:`ClassificationModel` under its
JAX module path, so an instance either package trains deploys in the
other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    AverageMetric,
    DataSource,
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    FirstServing,
    IdentityPreparator,
    WorkflowContext,
)
from predictionio_tpu_torch.data import store as event_store
from predictionio_tpu_torch.models.linear import (
    LogisticRegressionParams,
    logreg_predict,
    logreg_train,
)
from predictionio_tpu_torch.models.naive_bayes import NaiveBayesParams, nb_predict, nb_train
from predictionio_tpu_torch.utils import jaxpickle


@dataclass
class DataSourceParams:
    app_name: str = ""
    attrs: List[str] = field(default_factory=lambda: ["attr0", "attr1", "attr2"])
    label: str = "label"
    entity_type: str = "user"
    eval_k: int = 0
    eval_seed: int = 3


@dataclass
class LabeledData:
    X: np.ndarray  # (n, d) float32
    y: np.ndarray  # (n,) int32
    attrs: List[str]


class ClassificationDataSource(DataSource):
    ParamsClass = DataSourceParams

    def _read(self, ctx: WorkflowContext) -> LabeledData:
        p: DataSourceParams = self.params
        snap = event_store.aggregate_properties(
            p.app_name, p.entity_type, storage=ctx.storage)
        rows, labels = [], []
        for _, props in snap.items():
            try:
                feats = [float(props[a]) for a in p.attrs]
                label = int(float(props[p.label]))
            except (KeyError, TypeError, ValueError):
                continue
            rows.append(feats)
            labels.append(label)
        if not rows:
            raise ValueError(
                f"no entities with properties {p.attrs + [p.label]} found; "
                "$set them before `pio train`")
        return LabeledData(np.asarray(rows, np.float32),
                           np.asarray(labels, np.int32), list(p.attrs))

    def read_training(self, ctx: WorkflowContext) -> LabeledData:
        return self._read(ctx)

    def read_eval(self, ctx: WorkflowContext):
        p: DataSourceParams = self.params
        if p.eval_k <= 0:
            raise ValueError("set dataSourceParams.evalK > 0 to evaluate")
        data = self._read(ctx)
        rng = np.random.default_rng(p.eval_seed)
        fold_of = rng.integers(0, p.eval_k, size=len(data.y))
        folds = []
        for f in range(p.eval_k):
            tr = fold_of != f
            te = fold_of == f
            td = LabeledData(data.X[tr], data.y[tr], data.attrs)
            qa = [
                (dict(zip(data.attrs, map(float, row))), float(label))
                for row, label in zip(data.X[te], data.y[te])
            ]
            folds.append((td, {"fold": f}, qa))
        return folds


class ClassificationModel:
    def __init__(self, kind: str, attrs: List[str], **arrays) -> None:
        self.kind = kind
        self.attrs = attrs
        self.arrays = arrays

    def features(self, query: Dict[str, Any]) -> np.ndarray:
        return np.asarray([[float(query.get(a, 0.0)) for a in self.attrs]],
                          np.float32)


# -- the blob across packages ---------------------------------------------------

#: the model class → its JAX package name; the blob (the pickled model)
#: names the class so whichever package wrote it
BLOB_NAMES: jaxpickle.Names = {ClassificationModel: (
    "predictionio_tpu.templates.classification.engine", "ClassificationModel")}


class BlobAlgorithm(Algorithm):
    """An algorithm of this template or of text classification: its model
    is pickled whole, with ``blob_names`` naming its classes as the JAX
    package does."""

    blob_names: jaxpickle.Names = BLOB_NAMES
    blob_what = "classification blob"

    def sanity_check(self, data) -> None:
        if len(data.y) == 0:
            raise ValueError("empty training data")

    def save_model(self, model, instance_dir: Optional[str]) -> bytes:
        return jaxpickle.dumps(model, self.blob_names)

    def load_model(self, blob: Optional[bytes], instance_dir: Optional[str]):
        if blob is None:
            raise ValueError(f"{type(self).__name__}.load_model needs the model blob")
        return jaxpickle.loads(blob, self.blob_names, self.blob_what)


def _qa_features(attrs: List[str], qa) -> tuple:
    """Held-out (query, label) pairs → the same feature rows
    ``ClassificationModel.features`` builds at serve time (missing
    attrs read 0.0), so device-side sweep scoring sees the inputs of the
    serial predict path."""
    Xe = np.asarray([[float(q.get(a, 0.0)) for a in attrs] for q, _ in qa],
                    np.float32)
    ye = np.asarray([int(float(a)) for _, a in qa], np.int32)
    return Xe, ye


def nb_sweep_programs(ctx: WorkflowContext, X, y, Xe, ye, params_list):
    """NaiveBayes candidates of a fold as sweep programs, one per
    model_type; hyper rows are ``[lambda_]``."""
    from predictionio_tpu_torch.core.sweep import SweepProgram
    from predictionio_tpu_torch.models.naive_bayes import nb_sweep_program

    num_classes = int(y.max()) + 1
    groups: Dict[str, List[int]] = {}
    for i, p in enumerate(params_list):
        groups.setdefault(p.model_type, []).append(i)
    progs = []
    for model_type, idxs in groups.items():
        geometry, build, data = nb_sweep_program(
            X, y, Xe, ye, num_classes, model_type == "bernoulli",
            device=ctx.device)
        hyper = np.asarray([[params_list[i].lambda_] for i in idxs], np.float32)
        progs.append(SweepProgram(geometry, build, hyper, data, idxs))
    return progs


def lr_sweep_programs(ctx: WorkflowContext, X, y, Xe, ye, params_list):
    """LogisticRegression candidates of a fold as sweep programs, one per
    (num_classes, iterations, optimizer); hyper rows are ``[reg,
    learning_rate]``."""
    from predictionio_tpu_torch.core.sweep import SweepProgram
    from predictionio_tpu_torch.models.linear import logreg_sweep_program

    data_classes = int(y.max()) + 1
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(params_list):
        key = (max(int(p.num_classes), data_classes),
               int(p.iterations), p.optimizer)
        groups.setdefault(key, []).append(i)
    # the algorithms' params carry no learning rate: the serial path
    # trains at LogisticRegressionParams' default, so the rows pin it
    lr = LogisticRegressionParams().learning_rate
    progs = []
    for (C, iters, optname), idxs in groups.items():
        geometry, build, data = logreg_sweep_program(
            X, y, Xe, ye, C, iters, optname, device=ctx.device)
        hyper = np.asarray([[params_list[i].reg, lr] for i in idxs], np.float32)
        progs.append(SweepProgram(geometry, build, hyper, data, idxs))
    return progs


@dataclass
class NBAlgoParams:
    lambda_: float = 1.0
    model_type: str = "multinomial"


class NaiveBayesAlgorithm(BlobAlgorithm):
    ParamsClass = NBAlgoParams

    @classmethod
    def sweep_programs(cls, ctx: WorkflowContext, pd: LabeledData,
                       params_list, qa, metric):
        """Distributed ``pio eval``: the smoothing grid per model_type is
        one closed-form fit+score program over the fold, on the device."""
        if getattr(metric, "sweep_kind", None) != "accuracy":
            return None
        Xe, ye = _qa_features(pd.attrs, qa)
        return nb_sweep_programs(ctx, pd.X, pd.y, Xe, ye, params_list)

    def train(self, ctx: WorkflowContext, pd: LabeledData) -> ClassificationModel:
        p: NBAlgoParams = self.params
        lp, lt = nb_train(pd.X, pd.y,
                          NaiveBayesParams(lambda_=p.lambda_,
                                           model_type=p.model_type),
                          device=self.device)
        return ClassificationModel("nb", pd.attrs, log_prior=lp, log_theta=lt,
                                   model_type=np.asarray([p.model_type == "bernoulli"]))

    def predict(self, model: ClassificationModel, query: Dict[str, Any]) -> Dict[str, Any]:
        kind = "bernoulli" if model.arrays["model_type"][0] else "multinomial"
        label = nb_predict(model.arrays["log_prior"], model.arrays["log_theta"],
                           model.features(query), kind)[0]
        return {"label": float(label)}


@dataclass
class LRAlgoParams:
    num_classes: int = 2
    iterations: int = 100
    reg: float = 0.0
    optimizer: str = "lbfgs"


class LogisticRegressionAlgorithm(BlobAlgorithm):
    ParamsClass = LRAlgoParams

    def train(self, ctx: WorkflowContext, pd: LabeledData) -> ClassificationModel:
        p: LRAlgoParams = self.params
        num_classes = max(p.num_classes, int(pd.y.max()) + 1)
        W, b = logreg_train(
            pd.X, pd.y,
            LogisticRegressionParams(num_classes=num_classes,
                                     iterations=p.iterations, reg=p.reg,
                                     optimizer=p.optimizer),
            device=self.device)
        return ClassificationModel("lr", pd.attrs, W=W, b=b)

    @classmethod
    def train_many(cls, ctx: WorkflowContext, pd: LabeledData,
                   params_list) -> List[ClassificationModel]:
        """Grid-search fan-out: one upload of the batch, the candidates
        one after another on ``ctx.device``. num_classes resolves per
        candidate exactly as ``train`` does."""
        from predictionio_tpu_torch.models.linear import logreg_train_many

        data_classes = int(pd.y.max()) + 1
        wbs = logreg_train_many(
            pd.X, pd.y,
            [LogisticRegressionParams(
                num_classes=max(p.num_classes, data_classes),
                iterations=p.iterations, reg=p.reg,
                optimizer=p.optimizer)
             for p in params_list],
            device=ctx.device)
        return [ClassificationModel("lr", pd.attrs, W=W, b=b)
                for W, b in wbs]

    @classmethod
    def sweep_programs(cls, ctx: WorkflowContext, pd: LabeledData,
                       params_list, qa, metric):
        """Distributed ``pio eval``: candidates sharing (num_classes,
        iterations, optimizer) share one train+score program over their
        stacked reg values."""
        if getattr(metric, "sweep_kind", None) != "accuracy":
            return None
        Xe, ye = _qa_features(pd.attrs, qa)
        return lr_sweep_programs(ctx, pd.X, pd.y, Xe, ye, params_list)

    def predict(self, model: ClassificationModel, query: Dict[str, Any]) -> Dict[str, Any]:
        label = logreg_predict(model.arrays["W"], model.arrays["b"],
                               model.features(query))[0]
        return {"label": float(label)}


@dataclass
class RFAlgoParams:
    """MLlib RandomForest knob names where they map (numTrees,
    maxDepth); thresholds/featureFrac drive the oblivious-tree
    discretization (models/forest.py)."""

    num_trees: int = 16
    max_depth: int = 5
    n_thresholds: int = 16
    feature_frac: float = 0.7
    seed: int = 0


class RandomForestAlgorithm(BlobAlgorithm):
    """The reference template's RandomForest variant as oblivious trees;
    handles the non-linear boundaries NB and logistic regression cannot."""

    ParamsClass = RFAlgoParams

    def train(self, ctx: WorkflowContext, pd: LabeledData) -> ClassificationModel:
        from predictionio_tpu_torch.models.forest import ForestParams, forest_train

        p: RFAlgoParams = self.params
        m = forest_train(pd.X, pd.y, ForestParams(
            n_trees=p.num_trees, max_depth=p.max_depth,
            n_thresholds=p.n_thresholds, feature_frac=p.feature_frac,
            seed=p.seed), device=self.device)
        return ClassificationModel(
            "rf", pd.attrs, feats=m.feats, thrs=m.thrs,
            leaf_probs=m.leaf_probs,
            n_classes=np.asarray([m.n_classes]))

    def predict(self, model: ClassificationModel, query: Dict[str, Any]) -> Dict[str, Any]:
        from predictionio_tpu_torch.models.forest import (ForestModel,
                                                          forest_predict_proba)

        fm = ForestModel(model.arrays["feats"], model.arrays["thrs"],
                         model.arrays["leaf_probs"],
                         int(model.arrays["n_classes"][0]))
        probs = forest_predict_proba(fm, model.features(query))[0]
        return {"label": float(np.argmax(probs)),
                "probs": {str(c): float(p) for c, p in enumerate(probs)}}


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=ClassificationDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={
            "naive": NaiveBayesAlgorithm,
            "lr": LogisticRegressionAlgorithm,
            "forest": RandomForestAlgorithm,
        },
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box) -------------------------------------


class Accuracy(AverageMetric):
    """Fraction of held-out rows labeled correctly."""

    #: distributed sweeps accumulate (#correct, #rows) on device; the
    #: base sweep_finalize (mean) folds them into the same fraction
    sweep_kind = "accuracy"

    def calculate_one(self, query, predicted, actual) -> float:
        return 1.0 if float(predicted.get("label", float("nan"))) == \
            float(actual) else 0.0


class ClsEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = Accuracy()


class DefaultGrid(EngineParamsGenerator):
    """NB smoothing vs logistic vs forest, 2 folds; app via
    $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        import os

        app = os.environ.get("PIO_EVAL_APP_NAME", "MyApp2")
        ds = DataSourceParams(app_name=app, eval_k=2)
        return [
            EngineParams(data_source_params=ds,
                         algorithms_params=[("naive", NBAlgoParams(lambda_=lam))])
            for lam in (0.5, 1.0)
        ] + [
            EngineParams(data_source_params=ds,
                         algorithms_params=[("lr", LRAlgoParams())]),
            EngineParams(data_source_params=ds,
                         algorithms_params=[("forest", RFAlgoParams())]),
        ]
