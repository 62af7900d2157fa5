"""Diagnose a graph-recall plateau: navigation failure against distance ties.

Counterpart of tools/diagnose_recall_ceiling.py. Given an index (an .npz
written by either package) and the workload it was built on, it measures:

1. Tie multiplicity around k on EXACT distances: how many candidates sit at
   or below the k-th neighbour's distance, at exact, 1e-6 and 1e-3 relative
   tolerance. If id-recall is capped while the multiplicity is ~k, ties are
   not the cause.
2. id-recall against distance-recall of the graph engine at one operating
   point. Distance-recall counts a found neighbour as correct when its
   distance is <= the true k-th distance; distance-recall well above
   id-recall means the engine finds equally near points with other ids (a
   tie-breaking loss), equal recalls a genuine navigation loss.

The ground truth is `brute_force_knn` (its selection is kernel K3 on the
card, ties to the lowest id), 64 neighbours a query; the graph engine is
`batched_search` over the loaded graph, `BATCH` queries a call.

  python -m flatnav_tpu_torch.tools.diagnose_recall_ceiling INDEX.npz
      [--n 1000000] [--dim 128] [--num-queries 8192] [--ef 1536]
      [--expand 16] [--centers-per-64k N] [--dtype float32] [--device cpu]

The data comes from `bench.synth.clustered` (the JAX tool's generator, byte
for byte). The index is loaded onto the CUDA card unless `--device cpu` is
given. `main` prints the JAX tool's lines and returns them as a dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

K, BATCH, GT_K = 10, 4096, 64
TOLERANCES = (("exact", 0.0), ("rel1e-6", 1e-6), ("rel1e-3", 1e-3))


def tie_multiplicity(gt_d: np.ndarray, k: int = K) -> dict:
    """Per tolerance: the mean count of the ground truth's candidates at or
    below (1 + eps) times the k-th distance, and the share of queries with
    more than k of them."""
    dk = gt_d[:, k - 1 : k]
    out = {}
    for name, eps in TOLERANCES:
        mult = (gt_d <= dk * (1.0 + eps)).sum(1)
        out[name] = {"mean": float(mult.mean()), "frac_past_k": float((mult > k).mean())}
    return out


def recalls(found_i: np.ndarray, found_d: np.ndarray, gt_i: np.ndarray, gt_d: np.ndarray,
            k: int = K) -> tuple[float, float]:
    """-> (id-recall, distance-recall) of the first k results."""
    idr = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                         for a, b in zip(found_i[:, :k], gt_i[:, :k])]))
    dk = gt_d[:, k - 1 : k]
    dr = float((found_d[:, :k] <= dk * (1 + 1e-6) + 1e-6).mean())
    return idr, dr


def diagnose(graph, metric, data: np.ndarray, queries: np.ndarray, ef: int, expand: int,
             k: int = K, batch: int = BATCH) -> dict:
    """The tool's numbers for a loaded graph and its workload."""
    from flatnav_tpu_torch.index import batched_search
    from flatnav_tpu_torch.ops import brute_force_knn

    dev = graph.vectors.device
    table = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    nq = q.shape[0]
    gt_d, gt_i = [], []
    for lo in range(0, nq, batch):
        d_, i_ = brute_force_knn(table, q[lo : lo + batch], GT_K, metric)
        gt_d.append(d_.cpu().numpy())
        gt_i.append(i_.cpu().numpy())
    gt_d, gt_i = np.concatenate(gt_d), np.concatenate(gt_i)
    ties = tie_multiplicity(gt_d, k)

    t0 = time.perf_counter()
    found_i, found_d = [], []
    for lo in range(0, nq, batch):
        r = batched_search(graph.vectors, graph.links, graph.labels, graph.num_nodes,
                           q[lo : lo + batch], k=k, ef=ef, metric=metric, expand_factor=expand)
        found_i.append(r.labels.cpu().numpy())
        found_d.append(r.dists.cpu().numpy())
    seconds = time.perf_counter() - t0
    idr, dr = recalls(np.concatenate(found_i), np.concatenate(found_d), gt_i, gt_d, k)
    return {"ties": ties, "id_recall": idr, "dist_recall": dr, "ef": ef, "expand": expand,
            "search_s": seconds, "verdict": "tie-breaking" if dr - idr > 0.01 else "navigation"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("index")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--num-queries", type=int, default=8192)
    ap.add_argument("--ef", type=int, default=1536)
    ap.add_argument("--expand", type=int, default=16)
    ap.add_argument("--centers-per-64k", type=int, default=None)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.index.serialize import load_index

    gen_kw = {}
    if args.centers_per_64k is not None:
        gen_kw["centers_per_64k"] = args.centers_per_64k
    data, queries = clustered(args.n, args.dim, args.num_queries, dtype=np.dtype(args.dtype),
                              **gen_kw)
    graph, metric, _ = load_index(args.index, device=args.device)
    out = diagnose(graph, metric, data, queries, args.ef, args.expand)
    for name, t in out["ties"].items():
        print(f"tie multiplicity ({name}): mean {t['mean']:.2f} (k={K}); "
              f"frac queries with ties past k: {t['frac_past_k']:.4f}")
    print(f"graph ef={args.ef} E={args.expand}: id-recall {out['id_recall']:.4f} "
          f"dist-recall {out['dist_recall']:.4f} ({out['search_s']:.1f}s)")
    if out["verdict"] == "tie-breaking":
        print("=> tie-breaking: the engine finds equally-near points with different ids")
    else:
        print("=> navigation: missing neighbors are genuinely farther than the found ones")
    return out


if __name__ == "__main__":
    main()
