"""The solve kernel's share of its roofline, in %: the bound of every
``chol_solve`` call of the window's trains over the rated entities
(``benchlib/work.solve_call_bound``) over the device time of the
kernels named here in the profiler's trace."""

from benchlib.readers import kernel_roofline

KERNELS = ("chol_solve_kernel",)


def read(ctx):
    if ctx.get("kind") != "als_train":
        return None
    return kernel_roofline(ctx, ctx["solve_bound_s_per_train"] * ctx["trains"], KERNELS)
