"""Finds the graph mix's operating point for one configuration, on the card.

    python annbench/sweep.py --config sift-128-euclidean

Builds the configuration's index from seed `SEED` as a cell's set-up does,
then walks `EF_SWEEP` for each expand factor of `E_SWEEP` (the north-star
runner's grids, `flatnav_tpu_torch/bench/northstar.py`) with the `TRAFFIC`
mix's requests (`request_queries` queries each, the test set in turn), and
stops each walk at the first ef whose recall@10 against the plain reference
meets `TARGET`. Each point is timed over at least `SECONDS` of requests, one
after another, after one untimed pass. The operating point is the point of
highest qps that meets the target, or, where none does, the point of highest
recall. Prints one JSON line a point and the choice last; the choice is
what the configuration's `graph` group holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EF_SWEEP = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072)
E_SWEEP = (16, 64)
TRAFFIC = "graph-r1000"
SEED = 0
#: recall@10 of the ann-benchmarks operating point
TARGET = 0.95
SECONDS = 2.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from annbench import reference, synth
    from annbench.registry import Registry, cell_params, form, index_args
    import flatnav_tpu_torch

    reg = Registry()
    cfg, traffic = reg.config(args.config), reg.traffic(TRAFFIC)
    k = cell_params(cfg, traffic)["args"]["K"]
    data, queries = synth.generate(cfg, SEED, "cuda")
    truth = reference.exact_knn(data, queries, k, form(cfg)[0])[1].cpu()
    data_np, q_np = data.cpu().numpy(), queries.cpu().numpy()
    del data, queries
    torch.cuda.empty_cache()

    index = flatnav_tpu_torch.index.create(**index_args(cfg))
    t0 = time.perf_counter()
    index.add(data_np, ef_construction=cfg["ef_construction"])
    torch.cuda.synchronize()
    print(json.dumps({"config": cfg["name"], "seed": SEED,
                      "build_s": time.perf_counter() - t0,
                      "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)

    rq = traffic["request_queries"]
    slices = [(lo, min(lo + rq, len(q_np))) for lo in range(0, len(q_np), rq)]
    points = []
    for e in E_SWEEP:
        index.set_expand_factor(e)
        for ef in EF_SWEEP:
            hits = 0
            for lo, hi in slices:
                _, ids = index.search(q_np[lo:hi], K=k, ef_search=ef)
                hits += reference.recall_hits(torch.from_numpy(ids).long(), truth[lo:hi])
            recall = hits / truth.numel()
            n_q, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < SECONDS:
                for lo, hi in slices:
                    index.search(q_np[lo:hi], K=k, ef_search=ef)
                    n_q += hi - lo
            qps = n_q / (time.perf_counter() - t0)
            points.append({"expand_factor": e, "ef_search": ef, "recall_at_10": recall,
                           "qps": qps})
            print(json.dumps(points[-1]), flush=True)
            if recall >= TARGET:
                break
    met = [p for p in points if p["recall_at_10"] >= TARGET]
    best = (max(met, key=lambda p: p["qps"]) if met
            else max(points, key=lambda p: p["recall_at_10"]))
    print(json.dumps({"config": cfg["name"], "choice": best, "target_met": bool(met)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
