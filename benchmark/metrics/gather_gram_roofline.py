"""The Gram kernel's share of its roofline, in %: the bound of every
``gather_gram`` call of the window's trains (``benchlib/work.
gram_call_bound`` from the valid slots, the distinct factor rows they
gather and the rows written) over the device time of the kernels named
here in the profiler's trace."""

from benchlib.readers import kernel_roofline

KERNELS = ("gather_gram_kernel", "reduce_chunks_kernel")


def read(ctx):
    if ctx.get("kind") != "als_train":
        return None
    return kernel_roofline(ctx, ctx["gram_bound_s_per_train"] * ctx["trains"], KERNELS)
