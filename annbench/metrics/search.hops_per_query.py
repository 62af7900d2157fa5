"""search.hops_per_query: beam entries expanded per query in the window: the
`hops` each `batched_search` result returns, summed, over the queries it
searched (index/search.py)."""

from annbench.spans import SEARCH

SPANS = [SEARCH]


def read(ctx):
    st = ctx.spans["window"].get("search")
    if not st or not st.counts["queries"]:
        return None
    return st.counts["hops"] / st.counts["queries"]
