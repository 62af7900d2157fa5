"""BigANN-class 10M runner: clustered 10M x 128 uint8, L2, M=32, k=10.

    python -m flatnav_tpu_torch.bench.bigann_10m [--n 10000000] [--nq 8192]
        [--efc 100] [--no-pq] [--pq-only] [--m-pq 16] [--m-pq4 16]
        [--pq-rerank 64] [--centers-per-64k C | --n-centers C] [--pq-graph]
        [--rebuild] [--no-baseline] [--device cpu] [--results-dir DIR]
        [--why TEXT]

Counterpart of benchmarks/run_bigann_10m.py (the bigann-10M regime of the
reference grid, experiments/Makefile:138-152), on `synth.clustered`'s uint8
quantisation. Every engine has exact integer distances:

  exact    `brute_force_knn`: exact int32 products (float64 on the card)
  fast     `fast_knn`, tile 262144, rerank 32: exact int32 ranking keys
  fused    `fused_knn`, rerank 32, called bare over all queries: K1 "mma" on
           the unpromoted uint8 rows (exact keys at d=128); fusednr without
           the exact rerank
  graph    batched beam search over the build's links; its hop scores in
           exact int32 (K2 serves float tables only). `EF_GRID` x `E_GRID`
           to the first point at the 0.95 target, else the best point timed
  pq       ADC scan (`pq_scan_knn`, tile 131072) over m_pq-byte codes
           trained on the first 500k rows (25 iterations), raw-vector rerank
           swept over `--pq-rerank`, 128, 256, 512, 1024 to the target; the
           ADC-only recall at the chosen width; then the 4-bit point
           (nibble-packed codes); `--pq-graph` adds the codes-only graph
           (`pq_beam_search` over this build's links, raw rerank)

Timing, results file and what does not come across from the JAX runner are
as in `bench/northstar.py`: results go to `bench/results/results_bigann_10m
[_n<n>].json` (`results_<variant>_10m...` for another generator), merged
over a file already there as the JAX runner merges its partial runs, and
carry `device`, `reduced`, `kernels` and `build_peak_bytes` (the build's
peak device memory). The reference baseline is read from the JAX run's
sidecar where one exists; it is never run here.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from flatnav_tpu_torch.bench import _northstar as ns
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.data_type import resolve_device
from flatnav_tpu_torch.index.search import batched_search
from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fast_knn, fused_knn
from flatnav_tpu_torch.ops.distances import query_block_distances
from flatnav_tpu_torch.quantization.pq import pq_beam_search, pq_scan_knn

N, D, M, NQ, K, EFC = 10_000_000, 128, 32, 8192, 10, 100
TARGET = 0.95
BATCH = 4096
EF_GRID = (256, 512, 1024, 2048)
E_GRID = (16, 64)
#: the raw-rerank widths a PQ point sweeps after --pq-rerank
PQ_RERANKS = (128, 256, 512, 1024)
PQ_GRAPH_POINTS = ((128, 16), (256, 16), (512, 16), (1024, 64))
#: rows a build checkpoint and an encode chunk take
CHUNK = 1_000_000

log = ns.logger("10m")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N, help="rows (default 10M)")
    ap.add_argument("--nq", type=int, default=NQ)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--pq-only", action="store_true")
    ap.add_argument("--no-pq", action="store_true")
    ap.add_argument("--efc", type=int, default=EFC)
    ap.add_argument("--m-pq", type=int, default=16, help="PQ subquantizers (code bytes a node)")
    ap.add_argument("--m-pq4", type=int, default=16,
                    help="subquantizers of the 4-bit point (m_pq4/2 code bytes a node)")
    ap.add_argument("--pq-rerank", type=int, default=64)
    ap.add_argument("--centers-per-64k", type=int, default=None,
                    help="the generator's cluster density (default 256)")
    ap.add_argument("--n-centers", type=int, default=None,
                    help="an absolute cluster count (397 matches the 1M c26 workload)")
    ap.add_argument("--pq-graph", action="store_true",
                    help="also measure the codes-only PQ graph over this build's links")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--results-dir", default=None,
                    help="where the results file goes (default bench/results/)")
    ap.add_argument("--why", default=None, help="why this run was cut, for `reduced`")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    device = ns.device_line(dev)
    log(f"device: {device}")
    scratch = ns.scratch()
    kernel_build_s = ns.build_kernels(dev)
    run_start = ns.launches()
    n, nq, efc = args.n, args.nq, args.efc
    gen_kw, variant = {}, "bigann"
    if args.centers_per_64k is not None:
        gen_kw["centers_per_64k"] = args.centers_per_64k
        variant = f"bigann-c{args.centers_per_64k}"
    if args.n_centers is not None:
        gen_kw["n_centers"] = args.n_centers
        variant = f"bigann-nc{args.n_centers}"
    data, queries = clustered(n, D, nq, dtype=np.uint8, **gen_kw)

    g, build_s, build_peak, build_launches = ns.build_checkpointed(
        data, cache=f"{scratch}/10m_{variant}_{n}_{D}_{M}_{efc}.npz", capacity=n, m=M, efc=efc,
        metric=MetricType.L2, dtype=torch.uint8, chunk=CHUNK, dev=dev, rebuild=args.rebuild,
        log=log)
    q_dev = torch.from_numpy(queries).to(dev)
    nv = g.num_nodes
    gt = ns.ground_truth(g.vectors, q_dev, K, MetricType.L2,
                         f"{scratch}/10m_gt_{variant}_{n}_{D}.npy", args.rebuild, BATCH,
                         n_valid=nv)

    def batches(fn, batch=BATCH):
        return lambda: np.concatenate([fn(q_dev[lo : lo + batch]).cpu().numpy()
                                       for lo in range(0, nq, batch)])

    engines, scan_peak = {}, None
    if not args.pq_only:
        ns.reset_peak(dev)
        runs = {
            "exact": batches(lambda q: brute_force_knn(g.vectors, q, K, MetricType.L2,
                                                       n_valid=nv)[1]),
            "fast": batches(lambda q: fast_knn(g.vectors, q, K, MetricType.L2, tile_size=262144,
                                               rerank=32, n_valid=nv)[1]),
            # bare: fused_knn picks its shapes and chunks the queries itself
            "fused": batches(lambda q: fused_knn(g.vectors, q, K, MetricType.L2, rerank=32,
                                                 n_valid=nv)[1], nq),
            "fusednr": batches(lambda q: fused_knn(g.vectors, q, K, MetricType.L2, rerank=32,
                                                   n_valid=nv, exact_rerank=False)[1], nq),
        }
        for name, run in runs.items():
            engines[name] = ns.scan_point(run, gt, dev, n, D)
            log(f"{name} engine: {engines[name]['qps']:.0f} qps @ recall "
                f"{engines[name]['recall']:.4f}")
        scan_peak = ns.peak_bytes(dev)

    pq_points = {}
    if not args.no_pq:
        pq_points = _pq_engines(args, data, queries, q_dev, g, gt, dev, scratch, variant)

    def run_graph(ef, expand):
        return batches(lambda q: batched_search(
            g.vectors, g.links, g.labels, nv, q, k=K, ef=ef, metric=MetricType.L2,
            expand_factor=expand).labels)

    rows, chosen = [], None
    for expand in () if args.pq_only else E_GRID:
        if chosen is not None:
            break
        for ef in EF_GRID:
            r = ns.recall(run_graph(ef, expand)(), gt)
            log(f"E={expand} ef={ef}: recall={r:.4f}")
            rows.append({"ef": ef, "expand": expand, "recall": r})
            if r >= TARGET:
                pt = ns.time_engine(run_graph(ef, expand), gt, dev)
                rows[-1].update(qps=pt["qps"], launches=pt["launches"])
                chosen = dict(rows[-1])
                break
    # no point met the target: time the best one, so the point has a rate
    if chosen is None and rows:
        best = max(rows, key=lambda r: r["recall"])
        pt = ns.time_engine(run_graph(best["ef"], best["expand"]), gt, dev)
        best.update(qps=pt["qps"], launches=pt["launches"])
        chosen = dict(best, target_missed=True)

    kernels = None
    if dev.type == "cuda" and not args.pq_only:
        kernels = {"scan_buckets": ns.k1_times(g.vectors[:nv], q_dev, MetricType.L2)}

    size_tag = "" if n == N else f"_n{n}"
    stem = "results_bigann_10m" if variant == "bigann" else f"results_{variant}_10m"
    ref = None
    sidecar = os.path.join(ns.REPO, "benchmarks", f"{stem}{size_tag}.json.refside.json")
    if not args.no_baseline and os.path.exists(sidecar):
        with open(sidecar) as f:
            ref = json.load(f)
        log("reference baseline read from the JAX run's sidecar")

    result = {
        "workload": f"clustered uint8 {n}x{D} L2 M={M} efc={efc} k={K}",
        "note": "BigANN-10M-class stand-in (no egress; synthetic clustered uint8). All "
                "engines use exact integer distances. The JAX record's graph collapse on "
                "this workload is the generator's overlapping clusters "
                "(benchmarks/results_ab_uint8.json), not the engine.",
        "build_seconds": round(build_s, 1),
        "generator": dict(gen_kw) or "defaults",
        "device": device,
        "reduced": ns.reduced(n, N, nq, NQ, args.why,
                              "PQ engines skipped (--no-pq)" if args.no_pq else "",
                              "scan and graph engines skipped (--pq-only)" if args.pq_only else ""),
        "build_peak_bytes": build_peak,
        "scan_peak_bytes": scan_peak,
        "kernel_build_seconds": kernel_build_s,
        "build_launches": build_launches,
        "launches": ns.launch_delta(run_start),
        "kernels": kernels,
    }
    for key, val in (("exact_engine", engines.get("exact")), ("fast_engine", engines.get("fast")),
                     ("fused_engine", engines.get("fused")),
                     ("fusednr_engine", engines.get("fusednr")),
                     ("pq_scan_engine", pq_points.get("pq")),
                     ("pq4_scan_engine", pq_points.get("pq4")),
                     ("pq_graph_engine", pq_points.get("pq_graph")),
                     ("reference_single_core", ref)):
        if val is not None:
            result[key] = val
    if rows:
        result["graph_operating_point"] = chosen
        result["sweep"] = rows
    path = ns.write_results(result, f"{stem}{size_tag}.json", args.results_dir, merge=True)
    log(f"wrote {os.path.relpath(path)}")
    print(json.dumps(result))
    return result


def _cached(path: str, rebuild: bool, make) -> np.ndarray:
    if os.path.exists(path) and not rebuild:
        return np.load(path)
    arr = make()
    np.save(path, arr)
    return arr


def _pq_engines(args, data, queries, q_dev, g, gt, dev, scratch, variant) -> dict:
    """-> {"pq": 8-bit point, "pq4": 4-bit point[, "pq_graph": point]}."""
    n, nq = data.shape[0], queries.shape[0]
    qf = queries.astype(np.float32)
    nv = g.num_nodes
    widths = (args.pq_rerank, *PQ_RERANKS)

    def scan_run(pq, codes_dev, rr, raw=True, **kw):
        extra = {"vectors": g.vectors} if raw else {}

        def go():
            out = []
            for lo in range(0, nq, BATCH):
                tables = pq.adc_tables(qf[lo : lo + BATCH])
                if raw:
                    extra["queries"] = q_dev[lo : lo + BATCH]
                _, ids = pq_scan_knn(codes_dev, tables, K, metric=MetricType.L2,
                                     tile_size=131072, rerank=rr, **extra, **kw)
                out.append(ids.cpu().numpy())
            return np.concatenate(out)
        return go

    out, sample = {}, data[:500_000].astype(np.float32)
    for key, m_pq, nbits in (("pq", args.m_pq, 8), ("pq4", args.m_pq4, 4)):
        tag = "codes" if nbits == 8 else "codes4"
        kw = {"packed_4bit": True} if nbits == 4 else {}
        best, pq, codes_dev = ns.pq_scan_point(
            D, m_pq, nbits, sample,
            lambda pq, tag=tag, m_pq=m_pq, nbits=nbits: _cached(
                f"{scratch}/10m_{tag}_{variant}_{n}_{D}_{m_pq}.npy", args.rebuild,
                lambda: ns.encode_chunks(pq, data, dev, CHUNK, pack=nbits == 4)),
            lambda codes: torch.from_numpy(codes).to(dev),
            lambda pq, codes_dev, rr, kw=kw: scan_run(pq, codes_dev, rr, **kw),
            widths, TARGET, gt, dev, f"{key}-scan", log)
        if nbits == 8:
            # the codebook's own ranking at the chosen width: no raw rerank
            best["adc_only_recall"] = ns.recall(
                scan_run(pq, codes_dev, best["rerank"], raw=False)(), gt)
            pq8, codes8 = pq, codes_dev
        out[key] = best

    if args.pq_graph:
        def run_pq_graph(ef, expand, rr):
            def go():
                res = []
                for lo in range(0, nq, BATCH):
                    tables = pq8.adc_tables(qf[lo : lo + BATCH])
                    beam = pq_beam_search(codes8, g.links, nv, tables, ef=ef,
                                          metric=MetricType.L2, expand_factor=expand)
                    short = beam.ids[:, :rr]
                    rows = g.vectors[short.clamp(0, nv - 1).long()]
                    exact = query_block_distances(q_dev[lo : lo + BATCH], rows, MetricType.L2)
                    exact = torch.where(torch.isinf(beam.dists[:, :rr]), float("inf"), exact)
                    order = torch.argsort(exact, dim=1, stable=True)[:, :K]
                    res.append(short.gather(1, order).cpu().numpy())
                return np.concatenate(res)
            return go

        best = None
        for ef, expand in PQ_GRAPH_POINTS:
            rr = min(ef, 128)
            pt = ns.time_engine(run_pq_graph(ef, expand, rr), gt, dev)
            pt.update(ef=ef, expand=expand, rerank=rr)
            log(f"pq-graph ef={ef} E={expand}: {pt['qps']:.0f} qps @ recall {pt['recall']:.4f}")
            if best is None or (pt["recall"], pt["qps"]) > (best["recall"], best["qps"]):
                best = pt
            if pt["recall"] >= TARGET:
                best = pt
                break
        best.update(code_bytes_per_node=args.m_pq, links_from="raw exact-distance build")
        out["pq_graph"] = best
    return out


if __name__ == "__main__":
    main()
