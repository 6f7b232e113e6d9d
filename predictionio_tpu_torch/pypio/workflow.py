"""Cleanup hooks: callables a Python engine registers to run after
training (the reference's ``CleanupFunctions``), and event compaction."""

from __future__ import annotations

from typing import Callable, List


class CleanupFunctions:
    """Register post-train cleanup callables; ``run()`` executes them in
    registration order."""

    _fns: List[Callable[[], None]] = []

    @classmethod
    def add(cls, fn: Callable[[], None]) -> None:
        cls._fns.append(fn)

    @classmethod
    def run(cls) -> None:
        for fn in list(cls._fns):
            fn()

    @classmethod
    def clear(cls) -> None:
        cls._fns.clear()


def clean_events(app_name: str, keep_days: int = 30,
                 remove_duplicates: bool = True,
                 compress_properties: bool = True):
    """Compact an app's event log from a notebook through the port's
    ``data/cleaning`` machinery. Returns the {"kept", "dropped",
    "compacted"} counts."""
    import datetime as dt

    from predictionio_tpu_torch.data.cleaning import (
        EventWindow,
        clean_persisted_events,
    )
    from predictionio_tpu_torch.pypio.pypio import _st

    return clean_persisted_events(
        app_name,
        window=EventWindow(duration=dt.timedelta(days=keep_days),
                           remove_duplicates=remove_duplicates,
                           compress_properties=compress_properties),
        storage=_st(),
    )
