"""search.dist_comps_per_query: distances the graph search computed per query
in the program phase's requests with the tracer on: the program's counters
`search.dist_computations` over `search.queries` (index/search.py: the entry
scan, then every fresh neighbour a hop scores; annbench/program.py)."""

from annbench import program

SPANS = program.SPANS


def read(ctx):
    counts = program.table(ctx)
    if not counts[("counter", "search.queries")]:
        return None
    return counts[("counter", "search.dist_computations")] / counts[("counter", "search.queries")]
