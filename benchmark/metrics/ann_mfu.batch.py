"""The whole ANN dispatch's share of the chip's peaks, in %: the bound of
the window's dispatches (``benchlib/work.ann_dispatch_bound``: LUT, ADC
adds over every code, the exact re-rank, codes read once) over the
traced window."""

from benchlib.readers import step_share


def read(ctx):
    if ctx.get("kind") != "ann_batch":
        return None
    return step_share(ctx, ctx["ann_bound_s"])
