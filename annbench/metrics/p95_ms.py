"""p95_ms: the 95th percentile of the window's request latencies (host clock
from the call until its ids and distances are on the host), over all
requests of the window, numpy's linear interpolation."""

import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_s), 95) * 1e3)
