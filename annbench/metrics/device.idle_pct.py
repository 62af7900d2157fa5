"""device.idle_pct: the share of the profiled requests' window in which no
operation ran on the card (torch.profiler's device trace), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
