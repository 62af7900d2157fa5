"""request.p95_ms: the 95th percentile of the window's request latencies, as
`p95_ms` reads it (host clock from the call until its ids and distances are
on the host, over all requests of the window, numpy's linear interpolation).

A per-layer metric in the cells where that tail follows the host's stalls
more widely than an end-to-end bound can hold (sift1m.graph: PERF.md §2);
`p95_ms` stays end to end in the others."""

import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_s), 95) * 1e3)
