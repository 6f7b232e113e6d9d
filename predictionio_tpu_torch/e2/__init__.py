"""e2 — the engine-helper library, ported from the JAX package's ``e2``.

Helper models usable from any engine template without the full DASE
machinery: a categorical Naive Bayes over string features, a Markov-chain
transition model (both count on the device, CUDA unless the caller asks
for the CPU) and an external-process engine bridge.
"""

from predictionio_tpu_torch.e2.external import ExternalAlgorithm
from predictionio_tpu_torch.e2.markov import MarkovChainModel, markov_chain_train
from predictionio_tpu_torch.e2.naivebayes import (
    CategoricalNaiveBayesModel,
    LabeledPoint,
    categorical_naive_bayes_train,
)

__all__ = [
    "LabeledPoint",
    "CategoricalNaiveBayesModel",
    "categorical_naive_bayes_train",
    "MarkovChainModel",
    "markov_chain_train",
    "ExternalAlgorithm",
]
