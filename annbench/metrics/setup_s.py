"""setup_s: process start to the first timed request: imports, data on the
card and back to the host, the program's set-up (the graph build where the
mix builds one) and the warm-up passes."""


def read(ctx):
    return ctx.setup_s
