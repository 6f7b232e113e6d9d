"""The device's idle share of the traced window, in %: the window's
length less the union of its kernel, copy and set intervals (the
profiler's trace), over the window's length."""

from benchlib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
