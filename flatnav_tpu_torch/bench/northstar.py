"""North-star 1M runner: the BASELINE.md configurations beyond the README
workload, on synthetic stand-ins.

    python -m flatnav_tpu_torch.bench.northstar --config angular [--efc 200]
        [--n 1000000] [--centers-per-64k 26] [--no-baseline] [--rebuild]
        [--skip-scan-engines] [--chunk ROWS] [--build-dtype bfloat16]
        [--max-wave W] [--device cpu] [--results-dir DIR] [--why TEXT]

Counterpart of benchmarks/run_northstar.py (which subsumes
run_clustered_1m.py):

  clustered  1M x 128 float32 L2 (SIFT1M-class)
  angular    1M x 100 float32 IP over L2-normalised rows (GloVe-100-class)
  gist       1M x 960 float32 L2 (GIST1M-class)

M=32, 8,192 queries, K=10. Five engines, each timed by `_northstar`'s rule
(one warm-up that gives the recall, then the best of 3, synchronised, ids on
the host): exact (`brute_force_knn`), fast (`fast_knn`, rerank 32), fused and
fusednr (`fused_knn`, rerank 32, with and without the exact rerank), and the
graph, whose `EF_SWEEP` walk for each expand factor of `E_SWEEP` stops at the
first point that meets `--target` and times it; the fastest such point is the
operating point. `--build-dtype bfloat16` builds on a bf16 table and serves
the links over the float32 rows.

The reference C++ baseline is read, at `--n` 1,000,000 only, from the JAX
run's sidecar of the same variant and efc
(`benchmarks/results_<variant>_efc<efc>.json.refside.json`); it is never
built or run here. Results go to `bench/results/results_<variant>_efc<efc>
[_n<n>].json` with the JAX file's keys plus `device` (the card's name and
power limit), `reduced` (what this run cut, and `--why`), `kernels` (K1 and
K2 alone at this run's shapes), the build's peak device bytes and each
point's kernel launches. The JAX results files are never written.

What of the JAX runner does not come across, and why: the relaunch on
RESOURCE_EXHAUSTED with its persisted wave cap, the per-engine and
per-point fault markers and their resume files, and the shell relaunch
loops. They nursed a remote TPU runtime whose usable memory was opaque;
here an OOM or a failed kernel is a bug to report and ends the run nonzero.
The generated data is not cached either (it exists to spare relaunches).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from flatnav_tpu_torch.bench import _northstar as ns
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.data_type import resolve_device, to_numpy
from flatnav_tpu_torch.index.graph import graph_from_numpy
from flatnav_tpu_torch.index.search import batched_search
from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fast_knn, fused_knn

CONFIGS = {
    "clustered": dict(dim=128, metric=MetricType.L2, normalize=False),
    "angular": dict(dim=100, metric=MetricType.IP, normalize=True),
    "gist": dict(dim=960, metric=MetricType.L2, normalize=False),
}

M, NQ, K, BATCH = 32, 8192, 10, 4096
EF_SWEEP = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072)
E_SWEEP = (16, 64)
#: the source's scale; another --n (or NQ) is a cut, recorded in `reduced`
FULL_N, FULL_NQ = 1_000_000, 8192

log = ns.logger("northstar")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), required=True)
    ap.add_argument("--n", type=int, default=FULL_N)
    ap.add_argument("--efc", type=int, default=100)
    ap.add_argument("--target", type=float, default=0.95)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--skip-scan-engines", action="store_true",
                    help="only sweep the graph engine")
    ap.add_argument("--chunk", type=int, default=None,
                    help="build-checkpoint chunk rows (default: 250k at d=128, "
                         "scaled down with d to 62.5k at d >= 512)")
    ap.add_argument("--build-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="table dtype during construction only; the built links "
                         "serve the float32 rows")
    ap.add_argument("--max-wave", type=int, default=None, help="cap the build wave width")
    ap.add_argument("--centers-per-64k", type=int, default=None,
                    help="the generator's cluster density (default 256)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--results-dir", default=None,
                    help="where the results file goes (default bench/results/)")
    ap.add_argument("--why", default=None, help="why this run was cut, for `reduced`")
    args = ap.parse_args(argv)
    if args.chunk is not None and args.chunk <= 0:
        ap.error("--chunk must be a positive row count")
    return args


def make_data(config: str, n: int, gen_kw: dict):
    """The runner's (data, queries): `clustered` at the config's width,
    L2-normalised for angular (the JAX runner's normalisation)."""
    data, queries = clustered(n, CONFIGS[config]["dim"], NQ, **gen_kw)
    if CONFIGS[config]["normalize"]:
        data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-12
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12
    return data, queries


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]
    dim, metric = cfg["dim"], cfg["metric"]
    device = ns.device_line(dev)
    log(f"device: {device}")
    scratch = ns.scratch()
    kernel_build_s = ns.build_kernels(dev)
    run_start = ns.launches()

    gen_kw, variant = {}, args.config
    if args.centers_per_64k is not None:
        gen_kw["centers_per_64k"] = args.centers_per_64k
        variant = f"{args.config}-c{args.centers_per_64k}"
    data, queries = make_data(args.config, args.n, gen_kw)

    bd_tag = "" if args.build_dtype == "float32" else "_bf16"
    chunk = args.chunk if args.chunk is not None else max(62_500, 250_000 * 128 // dim)
    add_kw = {} if args.max_wave is None else {"max_wave": args.max_wave}
    g, build_s, build_peak, build_launches = ns.build_checkpointed(
        data, cache=f"{scratch}/ns_{variant}_{args.n}_{dim}_{M}_{args.efc}{bd_tag}.npz",
        capacity=args.n, m=M, efc=args.efc, metric=metric, dtype=getattr(torch, args.build_dtype),
        chunk=chunk, dev=dev, rebuild=args.rebuild, log=log, **add_kw)
    if args.build_dtype != "float32":
        # serve at full precision: the float32 rows under the links built on
        # the bf16 table (labels are arange in both)
        g = graph_from_numpy(data, to_numpy(g.links[: args.n]), num_nodes=args.n,
                             capacity=args.n, device=dev)

    q_dev = torch.from_numpy(queries).to(dev)
    gt = ns.ground_truth(torch.from_numpy(data).to(dev), q_dev, K, metric,
                         f"{scratch}/ns_{variant}_{args.n}_gt.npy", args.rebuild, BATCH)

    def batches(fn):
        return lambda: np.concatenate([fn(q_dev[lo : lo + BATCH]).cpu().numpy()
                                       for lo in range(0, q_dev.shape[0], BATCH)])

    engines = {}
    if not args.skip_scan_engines:
        # large-d tables: the [B, tile] keys ride beside the table, so the
        # tile that wins at d=128 is scaled down
        fast_tile = 262144 if dim <= 256 else 65536
        nv = g.num_nodes
        runs = {
            "exact": lambda q: brute_force_knn(g.vectors, q, K, metric, n_valid=nv)[1],
            "fast": lambda q: fast_knn(g.vectors, q, K, metric, tile_size=fast_tile, rerank=32,
                                       n_valid=nv)[1],
            "fused": lambda q: fused_knn(g.vectors, q, K, metric, rerank=32, n_valid=nv)[1],
            "fusednr": lambda q: fused_knn(g.vectors, q, K, metric, rerank=32, n_valid=nv,
                                           exact_rerank=False)[1],
        }
        for name, fn in runs.items():
            engines[name] = ns.scan_point(batches(fn), gt, dev, args.n, dim)
            log(f"{name} engine: {engines[name]['qps']:.0f} qps @ recall "
                f"{engines[name]['recall']:.4f}")

    def run_graph(ef, expand):
        return batches(lambda q: batched_search(
            g.vectors, g.links, g.labels, g.num_nodes, q, k=K, ef=ef, metric=metric,
            expand_factor=expand).labels)

    rows, chosen = [], None
    for expand in E_SWEEP:
        for ef in EF_SWEEP:
            r = ns.recall(run_graph(ef, expand)(), gt)
            log(f"E={expand} ef={ef}: recall={r:.4f}")
            rows.append({"ef": ef, "expand": expand, "recall": r})
            if r >= args.target:
                pt = ns.time_engine(run_graph(ef, expand), gt, dev)
                rows[-1].update(qps=pt["qps"], launches=pt["launches"])
                log(f"E={expand} ef={ef}: {pt['qps']:.0f} qps")
                if chosen is None or pt["qps"] > chosen["qps"]:
                    chosen = dict(rows[-1], efc=args.efc)
                break

    # the kernels alone at this run's shapes: K1 at the fused engine's first
    # query chunk, K2 at a full-width hop of the operating point (else the
    # sweep's last point)
    kernels = None
    if dev.type == "cuda":
        ef, expand = (chosen["ef"], chosen["expand"]) if chosen else (EF_SWEEP[-1], E_SWEEP[-1])
        saved = ns.launches()  # the recording search is not one of the run's points
        with ns.recorded_hop(expand * M) as hop:
            batched_search(g.vectors, g.links, g.labels, g.num_nodes, q_dev[:BATCH], k=K, ef=ef,
                           metric=metric, expand_factor=expand)
        ns.restore_launches(saved)
        kernels = {"scan_buckets": ns.k1_times(g.vectors[: g.num_nodes], q_dev[:BATCH], metric),
                   "gather_distances": ns.k2_times(hop.args)}

    ref = None
    if not args.no_baseline and args.n == FULL_N:
        ref = ns.sidecar(variant, args.efc)
        if ref is not None:
            log(f"reference baseline read from the JAX run's sidecar ({variant}, efc {args.efc})")

    result = {
        "workload": f"{variant} {args.n}x{dim} fp32 {metric.value} M={M} efc={args.efc} k={K}",
        "generator": dict(gen_kw) or "defaults",
        "note": "synthetic stand-in (no egress); angular = IP over L2-normalized rows, "
                "reference grid experiments/Makefile:333-381",
        "build_seconds": round(build_s, 1),
        "build_dtype": args.build_dtype,
        "exact_engine": engines.get("exact"),
        "fast_engine": engines.get("fast"),
        "fused_engine": engines.get("fused"),
        "fusednr_engine": engines.get("fusednr"),
        "graph_operating_point": chosen,
        "sweep": rows,
        "reference_single_core": ref,
        "device": device,
        "reduced": ns.reduced(args.n, FULL_N, NQ, FULL_NQ, args.why,
                           "scan engines skipped (--skip-scan-engines)"
                           if args.skip_scan_engines else ""),
        "build_peak_bytes": build_peak,
        "kernel_build_seconds": kernel_build_s,
        "build_launches": build_launches,
        "launches": ns.launch_delta(run_start),
        "kernels": kernels,
    }
    size_tag = "" if args.n == FULL_N else f"_n{args.n}"
    path = ns.write_results(result, f"results_{variant}_efc{args.efc}{size_tag}.json",
                            args.results_dir)
    log(f"wrote {os.path.relpath(path)}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
