"""build_s: host seconds of `Index.add` in the set-up, synchronised (the wave
build, index/build.py). Nothing where the mix builds no graph."""


def read(ctx):
    return ctx.build_s
