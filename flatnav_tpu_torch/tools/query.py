"""Load an index, run a query sweep, report recall and latency.

Counterpart of tools/query.py, the CLI analog of the reference's query_npy
tool (tools/query_npy.cpp:73-158): loads a saved index (written by either
package), queries it over a sweep of ef_search values, and reports mean
recall and per-query latency against a ground-truth file. Optional graph
reordering before the sweep (query_npy.cpp:34-41).

  python -m flatnav_tpu_torch.tools.query <index.npz> <queries file>
      <gtruth file> --ef-search 100 200 500 --k 100 [--reorder]
      [--batch 2048] [--device cpu]

The index is loaded onto the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("index")
    ap.add_argument("queries")
    ap.add_argument("gtruth")
    ap.add_argument("--ef-search", type=int, nargs="+", default=[100])
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--reorder", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import flatnav_tpu_torch
    from flatnav_tpu_torch.bench.metrics import recall_at_k
    from flatnav_tpu_torch.tools.construct import load_vectors

    index = flatnav_tpu_torch.index.load_index(
        args.index, verbose=True, device=args.device
    )
    queries = load_vectors(args.queries)
    gtruth = load_vectors(args.gtruth).astype(np.int64)

    if args.reorder:
        t0 = time.perf_counter()
        index.reorder(["gorder"])
        print(f"gorder reordering: {time.perf_counter() - t0:.1f}s")

    index.set_query_batch_size(args.batch)
    nq = queries.shape[0]
    for ef in args.ef_search:
        # warm-up: the first dispatch pays the kernel's build and load
        index.search(queries[: args.batch], K=args.k, ef_search=ef)
        t0 = time.perf_counter()
        _, labels = index.search(queries, K=args.k, ef_search=ef)
        total = time.perf_counter() - t0  # search ends in a copy to the host
        k = min(args.k, gtruth.shape[1])
        recall = recall_at_k(labels, gtruth)  # shared clamped definition
        print(
            f"ef_search={ef}: recall@{k}={recall:.4f} "
            f"qps={nq / total:.0f} mean_latency={total / nq * 1e6:.1f}us"
        )


if __name__ == "__main__":
    main()
