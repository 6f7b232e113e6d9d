"""The whole ALS train's share of the chip's float32 peak, in %: model
FLOPs of the window's trains (``benchlib/work.als_model_flops``: per
rating the symmetric half of f fᵀ and r·f, per rated entity a Cholesky
and two triangular solves; no bucket, padding or dense-head cell
counted) over the traced window at 67 TFLOP/s."""

from benchlib.readers import flops_share


def read(ctx):
    if ctx.get("kind") != "als_train":
        return None
    return flops_share(ctx, ctx["model_flops_per_train"] * ctx["trains"])
