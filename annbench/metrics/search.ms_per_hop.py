"""search.ms_per_hop: host milliseconds inside `batched_search` in the window
over the lockstep hops it ran (one K2 call a hop, index/search.py)."""

from annbench.spans import K2, SEARCH

SPANS = [SEARCH, K2]


def read(ctx):
    search, hops = ctx.spans["window"].get("search"), ctx.spans["window"].get("k2")
    if not search or not hops or not hops.calls:
        return None
    return search.seconds * 1e3 / hops.calls
