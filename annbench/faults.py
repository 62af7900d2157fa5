"""Planted faults, read on the card at a cell's own size: the readings below
which `correct`'s recall floor (`recall_floor`) has to lie (PERF.md).

    python3 annbench/faults.py --workload <cell> --seeds 1 2 3

The fault is one that the cell's set-up can have and that `dist_gap` cannot
see, since every id it returns is scored right:
- a graph cell (`setup: add`): the build commits no back edges, or none to
  every other target of each batch;
- a scan cell (`setup: allocate_nodes`): one K1 tile of the table, `TILE`
  rows in its middle, is out of every search's reach.

For each of the cell's faults and each seed it drives the rest of a run
(`run.run_cell`, a `WINDOW_S` window) with the fault planted in the
program, and prints one JSON line with the compared numbers. The
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WINDOW_S = 10.0
#: rows of the scan's dropped tile
TILE = 4096
#: what the dropped tile's rows hold, far from every query: float32 rows
#: under L2 sit at FAR in every column; rows scored by 1 - <q, x> are zero,
#: which scores 1 against every unit query; 8-bit rows sit at the type's
#: least value, below the 0.5th percentile of every column's data
FAR = 1e4


def no_back_edges(patch):
    """The build commits forward links only."""
    from flatnav_tpu_torch.index import build

    patch(build.LocalWave, "back_edges", lambda self, targets, requesters, metric: None)


def half_back_edges(patch):
    """Every other target of each back-edge batch gets no back edges."""
    from flatnav_tpu_torch.index import build

    real = build.LocalWave.back_edges

    def back_edges(self, targets, requesters, metric):
        targets = targets.clone()
        targets[1::2] = -1  # a padding lane's target
        real(self, targets, requesters, metric)

    patch(build.LocalWave, "back_edges", back_edges)


def _far(index) -> float:
    """The value of a row out of every query's reach, in the index's form."""
    import torch
    from flatnav_tpu_torch.ops.distances import MetricType

    if index.metric is MetricType.IP:
        return 0.0
    dtype = index.graph.vectors.dtype
    return FAR if dtype.is_floating_point else torch.iinfo(dtype).min


def tile_dropped(patch, tile: int = TILE):
    """`tile` rows in the middle of the table are moved out of reach once
    they are allocated, so no search returns them."""
    from flatnav_tpu_torch.index import api

    real = api.Index.allocate_nodes

    def allocate_nodes(self, data, labels=None):
        out = real(self, data, labels)
        lo = self.num_nodes // 2 // tile * tile
        self.graph.vectors[lo : lo + tile] = _far(self)
        return out

    patch(api.Index, "allocate_nodes", allocate_nodes)


#: the cell's faults, by its mix's `setup`
BY_SETUP = {"add": (no_back_edges, half_back_edges), "allocate_nodes": (tile_dropped,)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("faults: no CUDA device", file=sys.stderr)
        return 2
    from annbench.registry import Registry
    from annbench.run import run_cell

    reg = Registry()
    for fault in BY_SETUP[reg.traffic(reg.cell(args.workload)["traffic"])["setup"]]:
        with contextlib.ExitStack() as stack:
            fault(lambda obj, name, value: stack.enter_context(mock.patch.object(obj, name, value)))
            for seed in args.seeds:
                r = run_cell(reg, args.workload, seed, WINDOW_S, trace=False)
                print(json.dumps({"workload": args.workload, "fault": fault.__name__,
                                  "seed": seed, "correct": r["correct"],
                                  "check": {n: v["value"] for n, v in r["check"].items()}}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
