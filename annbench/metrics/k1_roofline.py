"""k1_roofline: K1 (`scan_buckets`, ops/fused_scan.py) against its roofline, in
%: the least time of every profiled call, by `bounds.scan_bound` at its
shapes, summed, over the device time of every kernel launched inside those
calls (torch.profiler)."""

from annbench.spans import K1

SPANS = [K1]


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.span_device_ms.get("k1")
    st = ctx.spans["trace"].get("k1")
    if not ms or not st or not st.bound_ms:
        return None
    return 100.0 * st.bound_ms / ms
