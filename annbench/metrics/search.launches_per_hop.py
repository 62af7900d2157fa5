"""search.launches_per_hop: device operations (kernels, copies, sets) launched
inside the program's `flatnav.search.hop` ranges in the program phase's
profiled requests, over the number of those ranges: one a lockstep hop of
`batched_search`, its end test included (index/search.py; torch.profiler;
annbench/program.py)."""

from annbench import program

SPANS = program.SPANS


def read(ctx):
    found = program.profiled(ctx)
    if not found.get("ranges.search.hop"):
        return None
    return found.get("ops.search.hop", 0) / found["ranges.search.hop"]
