"""Text classification template: hashed n-grams → NaiveBayes / logreg.

The port of the JAX package's template of the same path (the reference's
text classification template: documents as ``$set`` entity properties
with a text field and an integer label). Wire shapes:

    POST /queries.json  {"text": "the quick brown fox"}
    → {"label": 1.0}

The featurizer is the JAX package's hashing vectorizer, bit for bit
(unigrams and bigrams by default, crc32 into ``2**hash_bits`` buckets)
on the host; the count matrix trains the classification template's
models on the training device (CUDA unless the caller asks for the
CPU), and the distributed ``pio eval`` sweep runs the same
``sweep_programs`` hooks. The blob pickles :class:`TextModel` and
:class:`HashingConfig` under their JAX module paths.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from predictionio_tpu_torch.controller import (
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
from predictionio_tpu_torch.models.naive_bayes import (
    NaiveBayesParams,
    nb_predict,
    nb_train,
)
from predictionio_tpu_torch.templates.classification.engine import (
    Accuracy,
    BlobAlgorithm,
    lr_sweep_programs,
    nb_sweep_programs,
)
from predictionio_tpu_torch.utils import jaxpickle

_TOKEN_RE = re.compile(r"[a-z0-9']+")


@dataclass(frozen=True)
class HashingConfig:
    """The featurizer's shape knobs: ``2**hash_bits`` feature columns,
    n-grams 1..ngrams."""

    hash_bits: int = 12
    ngrams: int = 2

    @property
    def dim(self) -> int:
        return 1 << self.hash_bits


def hash_features(texts: List[str], cfg: HashingConfig) -> np.ndarray:
    """Hashed n-gram count matrix (n_docs, 2**hash_bits) float32 —
    deterministic (crc32), so train-time and query-time featurization
    agree bit for bit."""
    mask = cfg.dim - 1
    X = np.zeros((len(texts), cfg.dim), np.float32)
    for row, text in enumerate(texts):
        toks = _TOKEN_RE.findall(str(text).lower())
        for n in range(1, cfg.ngrams + 1):
            for i in range(len(toks) - n + 1):
                h = zlib.crc32(" ".join(toks[i:i + n]).encode()) & mask
                X[row, h] += 1.0
    return X


@dataclass
class TextDataSourceParams:
    app_name: str = ""
    text_prop: str = "text"
    label: str = "label"
    entity_type: str = "doc"
    hash_bits: int = 12
    ngrams: int = 2
    eval_k: int = 0
    eval_seed: int = 3


@dataclass
class TextLabeledData:
    """Hashed documents, columnar: the (X, y) contract of the
    classification template's LabeledData."""

    X: np.ndarray  # (n, 2**hash_bits) float32
    y: np.ndarray  # (n,) int32
    cfg: HashingConfig


class TextDataSource(DataSource):
    ParamsClass = TextDataSourceParams

    def _read_docs(self, ctx: WorkflowContext):
        p: TextDataSourceParams = self.params
        snap = event_store.aggregate_properties(
            p.app_name, p.entity_type, storage=ctx.storage)
        texts, labels = [], []
        for _, props in snap.items():
            try:
                text = str(props[p.text_prop])
                label = int(float(props[p.label]))
            except (KeyError, TypeError, ValueError):
                continue
            texts.append(text)
            labels.append(label)
        if not texts:
            raise ValueError(
                f"no entities with properties "
                f"[{p.text_prop!r}, {p.label!r}] found; $set documents "
                "before `pio train`")
        return texts, np.asarray(labels, np.int32)

    def _cfg(self) -> HashingConfig:
        p: TextDataSourceParams = self.params
        return HashingConfig(hash_bits=p.hash_bits, ngrams=p.ngrams)

    def read_training(self, ctx: WorkflowContext) -> TextLabeledData:
        texts, y = self._read_docs(ctx)
        cfg = self._cfg()
        return TextLabeledData(hash_features(texts, cfg), y, cfg)

    def read_eval(self, ctx: WorkflowContext):
        p: TextDataSourceParams = self.params
        if p.eval_k <= 0:
            raise ValueError("set dataSourceParams.evalK > 0 to evaluate")
        texts, y = self._read_docs(ctx)
        cfg = self._cfg()
        X = hash_features(texts, cfg)
        rng = np.random.default_rng(p.eval_seed)
        fold_of = rng.integers(0, p.eval_k, size=len(y))
        folds = []
        for f in range(p.eval_k):
            tr = fold_of != f
            te = np.nonzero(fold_of == f)[0]
            td = TextLabeledData(X[tr], y[tr], cfg)
            qa = [({"text": texts[j]}, float(y[j])) for j in te]
            folds.append((td, {"fold": f}, qa))
        return folds


class TextModel:
    def __init__(self, kind: str, cfg: HashingConfig, **arrays) -> None:
        self.kind = kind
        self.cfg = cfg
        self.arrays = arrays

    def features(self, query: Dict[str, Any]) -> np.ndarray:
        return hash_features([str(query.get("text", ""))], self.cfg)


# -- the blob across packages ---------------------------------------------------

_JAX_MODULE = "predictionio_tpu.templates.textclassification.engine"

#: the blob's classes → their JAX package names; the blob (the pickled
#: model and its featurizer config) names them so whichever package wrote it
BLOB_NAMES: jaxpickle.Names = {TextModel: (_JAX_MODULE, "TextModel"),
                               HashingConfig: (_JAX_MODULE, "HashingConfig")}


class _TextAlgorithm(BlobAlgorithm):
    blob_names = BLOB_NAMES
    blob_what = "text classification blob"


def _qa_matrix(cfg: HashingConfig, qa) -> tuple:
    """Held-out (query, label) pairs → the exact feature rows
    ``TextModel.features`` would build at serve time."""
    Xe = hash_features([str(q.get("text", "")) for q, _ in qa], cfg)
    ye = np.asarray([int(float(a)) for _, a in qa], np.int32)
    return Xe, ye


@dataclass
class TextNBParams:
    lambda_: float = 1.0
    model_type: str = "multinomial"


class TextNaiveBayesAlgorithm(_TextAlgorithm):
    ParamsClass = TextNBParams

    def train(self, ctx: WorkflowContext, pd: TextLabeledData) -> TextModel:
        p: TextNBParams = self.params
        lp, lt = nb_train(pd.X, pd.y,
                          NaiveBayesParams(lambda_=p.lambda_,
                                           model_type=p.model_type),
                          device=self.device)
        return TextModel(
            "nb", pd.cfg, log_prior=lp, log_theta=lt,
            model_type=np.asarray([p.model_type == "bernoulli"]))

    @classmethod
    def sweep_programs(cls, ctx: WorkflowContext, pd: TextLabeledData,
                       params_list, qa, metric):
        """Distributed ``pio eval``: the smoothing grid per model_type as
        one closed-form fit+score program over the hashed count matrix."""
        if getattr(metric, "sweep_kind", None) != "accuracy":
            return None
        Xe, ye = _qa_matrix(pd.cfg, qa)
        return nb_sweep_programs(ctx, pd.X, pd.y, Xe, ye, params_list)

    def predict(self, model: TextModel, query: Dict[str, Any]) -> Dict[str, Any]:
        kind = ("bernoulli" if model.arrays["model_type"][0]
                else "multinomial")
        label = nb_predict(model.arrays["log_prior"],
                           model.arrays["log_theta"],
                           model.features(query), kind)[0]
        return {"label": float(label)}


@dataclass
class TextLRParams:
    num_classes: int = 2
    iterations: int = 100
    reg: float = 0.0
    optimizer: str = "lbfgs"


class TextLogisticRegressionAlgorithm(_TextAlgorithm):
    ParamsClass = TextLRParams

    def train(self, ctx: WorkflowContext, pd: TextLabeledData) -> TextModel:
        p: TextLRParams = self.params
        num_classes = max(p.num_classes, int(pd.y.max()) + 1)
        W, b = logreg_train(
            pd.X, pd.y,
            LogisticRegressionParams(num_classes=num_classes,
                                     iterations=p.iterations, reg=p.reg,
                                     optimizer=p.optimizer),
            device=self.device)
        return TextModel("lr", pd.cfg, W=W, b=b)

    @classmethod
    def sweep_programs(cls, ctx: WorkflowContext, pd: TextLabeledData,
                       params_list, qa, metric):
        if getattr(metric, "sweep_kind", None) != "accuracy":
            return None
        Xe, ye = _qa_matrix(pd.cfg, qa)
        return lr_sweep_programs(ctx, pd.X, pd.y, Xe, ye, params_list)

    def predict(self, model: TextModel, query: Dict[str, Any]) -> Dict[str, Any]:
        label = logreg_predict(model.arrays["W"], model.arrays["b"],
                               model.features(query))[0]
        return {"label": float(label)}


def engine_factory() -> Engine:
    return Engine(
        data_source_cls=TextDataSource,
        preparator_cls=IdentityPreparator,
        algorithm_cls_map={
            "naive": TextNaiveBayesAlgorithm,
            "lr": TextLogisticRegressionAlgorithm,
        },
        serving_cls=FirstServing,
    )


# -- evaluation (pio eval out of the box) -------------------------------------


class TextEvaluation(Evaluation):
    engine_factory = staticmethod(engine_factory)
    metric = Accuracy()  # shared with classification (sweep_kind set)


class DefaultGrid(EngineParamsGenerator):
    """NB smoothing × logreg regularization, 2 folds; app via
    $PIO_EVAL_APP_NAME."""

    @property
    def engine_params_list(self):
        import os

        app = os.environ.get("PIO_EVAL_APP_NAME", "MyTextApp")
        ds = TextDataSourceParams(app_name=app, eval_k=2)
        return [
            EngineParams(data_source_params=ds,
                         algorithms_params=[("naive",
                                             TextNBParams(lambda_=lam))])
            for lam in (0.25, 0.5, 1.0)
        ] + [
            EngineParams(data_source_params=ds,
                         algorithms_params=[("lr", TextLRParams(reg=reg))])
            for reg in (0.0, 0.01)
        ]
