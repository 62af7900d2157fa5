"""k3_roofline: K3 (`select_k`, ops/select_k.py: phase B of the fused scan)
against its roofline, in %: the least time of every profiled call, by
`bounds.select_bound` at its shapes, summed, over the device time of every
kernel launched inside those calls (torch.profiler)."""

from annbench.spans import K3

SPANS = [K3]


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.span_device_ms.get("k3")
    st = ctx.spans["trace"].get("k3")
    if not ms or not st or not st.bound_ms:
        return None
    return 100.0 * st.bound_ms / ms
