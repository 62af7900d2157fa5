"""search.host_ms_per_hop: host milliseconds of a lockstep hop that the host
did not spend waiting on the card, in the program phase's unprofiled
requests with the tracer on: the program's `search.hop` spans' total minus
their `wait` children (the end test), over their calls (index/search.py;
annbench/program.py)."""

from annbench import program

SPANS = program.SPANS


def read(ctx):
    hop = program.span_sums(program.table(ctx), "search.hop")
    if not hop["calls"]:
        return None
    return (hop["total_ns"] - hop["wait_ns"]) / 1e6 / hop["calls"]
