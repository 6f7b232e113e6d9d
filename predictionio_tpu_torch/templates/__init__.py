"""Engine templates of the port. Each template module exposes
``engine_factory()`` plus its DASE component classes, and ships an
``engine.json`` the CLI copies into a new engine directory (``template new
<name> <dir>``)."""

#: the JAX package's registry with the port's module paths; ``template
#: list`` prints exactly this dict
TEMPLATES = {
    "recommendation": "predictionio_tpu_torch.templates.recommendation.engine",
    "classification": "predictionio_tpu_torch.templates.classification.engine",
    "textclassification": "predictionio_tpu_torch.templates.textclassification.engine",
    "similarproduct": "predictionio_tpu_torch.templates.similarproduct.engine",
    "ecommercerecommendation": "predictionio_tpu_torch.templates.ecommercerecommendation.engine",
    "universal": "predictionio_tpu_torch.templates.universal.engine",
    "twotower": "predictionio_tpu_torch.templates.twotower.engine",
    "sequentialrec": "predictionio_tpu_torch.templates.sequentialrec.engine",
    "vanilla": "predictionio_tpu_torch.templates.vanilla.engine",
}
