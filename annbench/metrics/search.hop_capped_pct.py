"""search.hop_capped_pct: the share of queries, in %, whose beam search the
hop cap cut short, in the program phase's requests with the tracer on: the
program's counters `search.hop_capped` (queries whose beam still held an
unexpanded entry when the hop loop stopped at its cap; index/search.py) over
`search.queries`, x 100 (annbench/program.py). None where the program
recorded no `search.hop_capped`; 0 where it recorded it and no query was
cut."""

from annbench import program

SPANS = program.SPANS


def read(ctx):
    counts = program.table(ctx)
    if ("counter", "search.hop_capped") not in counts or not counts[("counter", "search.queries")]:
        return None
    return 100.0 * counts[("counter", "search.hop_capped")] / counts[("counter", "search.queries")]
