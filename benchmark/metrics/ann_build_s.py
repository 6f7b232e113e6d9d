"""Seconds of the PQ index build, ``ann/index.build_index``, on the host
clock around the call in set-up, the card synchronised after it."""


def read(ctx):
    return ctx.get("ann_build_s")
