"""search.hop_idle_pct: the share of the program phase's profiled requests'
window in which the card idles in a gap that opens inside the program's
`search.hop` span or one of its stages (the innermost program range open on
the main thread at the gap's start), in % of the window (torch.profiler;
annbench/program.py)."""

from annbench import program

SPANS = program.SPANS


def read(ctx):
    found = program.profiled(ctx)
    if not found.get("ranges.search.hop") or not found.get("window_s"):
        return None
    return 100.0 * program.hop_idle_s(found) / found["window_s"]
