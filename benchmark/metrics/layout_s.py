"""Seconds of the host layout, ``models/als.als_prepare``, on the host
clock around the call in set-up."""


def read(ctx):
    return ctx.get("layout_s")
