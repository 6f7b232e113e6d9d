"""Helpers the per-layer metric readers (``metrics/<name>.py``) share.

A reader takes the run's context: the traced window (``trace``, a
``tracing.Trace``) and what the cell's driver counted about the
window's work (``layer_context``). It returns None when it finds
nothing to read, never 0 for a share of a roofline or a peak."""

from __future__ import annotations

from benchlib.work import PEAK_F32_FLOPS


def idle_pct(ctx: dict):
    """The device's idle share of the traced window, in %."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kernel_roofline(ctx: dict, bound_s: float, kernels) -> float:
    """The share of the named kernels' device time their work needs at
    the chip's peaks, in %."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    spent = tr.kernel_seconds(kernels)
    if spent <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / spent


def step_share(ctx: dict, bound_s: float):
    """The share of the traced window that the window's required work
    takes at the chip's peaks, in %."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / tr.window_s


def flops_share(ctx: dict, flops: float):
    return step_share(ctx, flops / PEAK_F32_FLOPS)
