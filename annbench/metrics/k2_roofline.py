"""k2_roofline: K2 (`gather_distances`, ops/gather_distance.py) against its
roofline, in %: the least time of every profiled call, by
`bounds.gather_bound` at its arguments, summed, over the device time of
every kernel launched inside those calls (torch.profiler). The count of
distinct rows that the bound needs is taken when the profiled requests run
again after the profile, so that no profiled call waits for it; the two runs
must make as many calls."""

from annbench.spans import K2

SPANS = [K2]


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.span_device_ms.get("k2")
    st = ctx.spans["replay"].get("k2")
    if not ms or not st or not st.bound_ms:
        return None
    if st.calls != ctx.spans["trace"]["k2"].calls:
        return None
    return 100.0 * st.bound_ms / ms
