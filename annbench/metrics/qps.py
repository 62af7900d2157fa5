"""qps: queries answered in the window over the window's seconds (host clock,
from the first request's start to the last answer's arrival)."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 else None
