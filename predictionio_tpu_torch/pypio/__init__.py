"""pypio — the notebook bridge over the port's storage.

The port's copy of the repo's ``pypio`` package (the reference's
``python/pypio``: PEventStore reads and model hand-off for PySpark and
Jupyter), with the same module names and the same calls, over
``predictionio_tpu_torch``'s storage. Reads return **pandas DataFrames**;
pandas is imported inside the functions that build them, so importing
the package needs no pandas:

    from predictionio_tpu_torch import pypio
    pypio.init()                       # bind storage from PIO_* env
    df = pypio.find_events("MyApp")    # events as a DataFrame
    props = pypio.data.PEventStore.aggregate_properties("MyApp", "user")
"""

from predictionio_tpu_torch.pypio import data, utils, workflow
from predictionio_tpu_torch.pypio.pypio import (
    find_events,
    init,
    load_model,
    save_model,
    stop,
)

__all__ = ["init", "stop", "find_events", "save_model", "load_model",
           "data", "workflow", "utils"]
