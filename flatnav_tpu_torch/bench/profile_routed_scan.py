"""Measure the two bounds of the cluster-routed scan, its recall and its time.

Counterpart of tools/profile_routed_scan.py, for `ops/routed_scan.py`:

  1. ROUTING CEILING: the fraction of true k-NN whose balanced-cell block
     lands in the query's top-P routed blocks, as a function of the scan
     fraction P*block/n. No pruned engine can exceed this recall while
     scanning that fraction.
  2. UNION CAPTURE: the fraction of each query's top-P probe list that a
     per-group vote union of U blocks actually scans (the shape that keeps
     the pruned scan one dense matmul a group), plus the number of distinct
     blocks a group votes for.

And the end-to-end recall of `routed_knn` at those settings next to the
ceiling, its recall with every block in the union (which must be 1.0: the
scan is exact over what it reads), and, on a CUDA card, its time by CUDA
events beside `fast_knn`'s on the same queries (null on the CPU: a CPU time
is not a device time). Prints one JSON line, last.

Usage:
  python -m flatnav_tpu_torch.bench.profile_routed_scan [--n 100000]
      [--dim 128] [--centers-per-64k 256] [--block 512] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from flatnav_tpu_torch.bench.measure import card, timed
from flatnav_tpu_torch.bench.metrics import recall_at_k as _recall
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.data_type import resolve_device
from flatnav_tpu_torch.ops import (
    MetricType,
    brute_force_knn,
    build_routed_scan,
    fast_knn,
    pairwise_distances,
    routed_knn,
)

#: (probes, union_blocks, group_size) settings measured end to end
SETTINGS = ((16, 32, 128), (32, 48, 128), (32, 64, 256))


def profile(n=100_000, dim=128, num_queries=1024, k=10, centers_per_64k=256,
            block=512, device=None) -> dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    nq = num_queries
    data, queries = clustered(n, dim, nq, centers_per_64k=centers_per_64k)
    ds, q = torch.from_numpy(data).to(dev), torch.from_numpy(queries).to(dev)
    _, gt_i = brute_force_knn(ds, q, k, MetricType.L2, tile_size=32768)
    gt_i = gt_i.cpu().numpy()

    rs = build_routed_scan(data, block=block, device=dev)
    nb = rs.block_centroids.shape[0]

    # block of every true neighbor
    ids_np = rs.ids.cpu().numpy()
    pos_of = np.full(n, -1, np.int64)
    real = ids_np >= 0
    pos_of[ids_np[real]] = np.flatnonzero(real)
    nbr_block = pos_of[gt_i] // rs.block

    route_d = pairwise_distances(q, rs.block_centroids, MetricType.L2).cpu().numpy()
    rank = np.argsort(route_d, axis=1, kind="stable")

    out = {
        "workload": f"clustered-c{centers_per_64k} {n}x{dim}",
        "device": card() if on_card else "cpu",
        "block": rs.block, "n_blocks": nb,
        "routing_ceiling": [],
        "union_capture": [],
        "end_to_end": [],
    }
    for P in (8, 16, 32, 48):
        if P > nb:
            continue
        cov = float(np.mean([
            np.isin(nbr_block[i], rank[i, :P]).mean() for i in range(nq)
        ]))
        out["routing_ceiling"].append(
            {"probes": P, "scan_fraction": round(P * rs.block / n, 4),
             "recall_ceiling": round(cov, 4)}
        )
        print(f"[routed] ceiling P={P} (scan {P*rs.block/n:.0%}): {cov:.4f}",
              file=sys.stderr)

    # union capture at the engine's group/union shapes
    for P, U, G in SETTINGS:
        if P > nb:
            continue
        topb = rank[:, :P]
        order = np.argsort(topb[:, 0], kind="stable")
        tb_sorted = topb[order]
        w = (P - np.arange(P)).astype(np.float64)
        w[0] = P * P
        caps, distincts = [], []
        for g0 in range(0, nq, G):
            tb_g = tb_sorted[g0 : g0 + G]
            votes = np.zeros(nb)
            np.add.at(votes, tb_g.ravel(), np.tile(w, (tb_g.shape[0], 1)).ravel())
            keep = np.argsort(-votes, kind="stable")[:U]
            caps.append(np.isin(tb_g, keep).mean())
            distincts.append(int((votes > 0).sum()))
        row = {"probes": P, "union": U, "group": G,
               "probe_capture": round(float(np.mean(caps)), 4),
               "distinct_voted_blocks": round(float(np.mean(distincts)), 1)}
        out["union_capture"].append(row)
        print(f"[routed] capture P={P} U={U} G={G}: "
              f"{row['probe_capture']:.3f} of probes scanned "
              f"({row['distinct_voted_blocks']:.0f}/{nb} blocks voted)",
              file=sys.stderr)

        def run():
            return routed_knn(rs, q, k, probes=P, union_blocks=U, group_size=G)

        r = _recall(run()[1].cpu().numpy(), gt_i)
        out["end_to_end"].append(
            {"probes": P, "union": U, "group": G,
             "scan_fraction": round(U * rs.block / n, 4),
             "recall": round(r, 4),
             "routed_knn_ms": timed(run, reps=5) if on_card else None}
        )
        print(f"[routed] end-to-end P={P} U={U} G={G}: recall {r:.4f}",
              file=sys.stderr)

    _, full = routed_knn(rs, q, k, union_blocks=nb, group_size=128)
    out["full_union_recall"] = _recall(full.cpu().numpy(), gt_i)
    _, fast_i = fast_knn(ds, q, k, MetricType.L2)
    out["fast_knn_recall"] = round(_recall(fast_i.cpu().numpy(), gt_i), 4)
    out["fast_knn_ms"] = (
        timed(lambda: fast_knn(ds, q, k, MetricType.L2), reps=5) if on_card else None
    )
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--num-queries", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--centers-per-64k", type=int, default=256)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    print(json.dumps(profile(
        args.n, args.dim, args.num_queries, args.k, args.centers_per_64k,
        args.block, args.device,
    )))


if __name__ == "__main__":
    main()
