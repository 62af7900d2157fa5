"""BigANN-100M-class runner: 100M x 128 uint8, L2, k=10, the whole table
resident on one card (12.8 GB).

    python -m flatnav_tpu_torch.bench.bigann_100m [--n 100000000] [--nq 8192]
        [--b 8192] [--pq-b 1024] [--rerank 32] [--m-pq 16] [--m-pq4 32]
        [--pq-rerank 64] [--pq-tile 32768] [--pq-nq Q] [--no-pq] [--pq-only] [--skip-exact]
        [--rebuild] [--workers W] [--device cpu] [--results-dir DIR] [--why TEXT]

Counterpart of benchmarks/run_bigann_100m.py (the reference's bigann-100M
scale, experiments/Makefile:8-23). Engines, against exact ground truth:

  exact    `brute_force_knn`, 2,048 queries a call: exact int32 products
           (float64 on the card)
  fused    `fused_knn` called bare over `--b` queries a call: it picks its
           own shapes and chunks the queries to bound its [B, N/L] phase-A
           summary (`ops/fused_scan._pick_shapes`); K1 runs its "wgmma_int8"
           variant on the unpromoted uint8 rows and uint8 queries, whose
           keys are exact at d=128;
           fusednr without the exact rerank
  pq       `pq_scan_knn` over lane-packed codes (`pack_codes_lanes`), trained
           on a 500k-row stride sample, with a raw-vector rerank from the
           resident table swept over `--pq-rerank`, 128, 256, 512 to the 0.95
           target; then the 4-bit point (nibble-packed, widths to 1024);
           `--pq-nq` gives them the first Q queries only (a cut, recorded)

No graph, as in the JAX runner: a 100M wave build is out of a run's scale.

The data is `gen_dataset`: the JAX runner's chunked generator, byte for byte
(seed 0x100E, the centres drawn up front, a child RNG a 2M-row chunk), into a
memory-mapped file under the scratch directory (`FLATNAV_SCRATCH`, else
`.scratch/`). The chunks are independent, so `--workers` processes write them
in parallel. Ground truth is the exact engine's first call, cached.

The result adds to the JAX file's keys `device` (the card's name and power
limit), `reduced`, `fused_shapes` (the L, T and query chunk `fused_knn` took),
`scan_peak_bytes` (peak device memory over the fused engines, the table
included) and `kernels` (K1 alone at the fused engine's shapes). It goes to `bench/results/results_bigann_100m_class[_n<n>].json`.
What of the JAX runner does not come across: its fault isolation of each
engine (`*_fault` keys) and the incremental flush for relaunches; here an OOM
or a failed kernel ends the run nonzero, as in `bench/northstar.py`.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import time

import numpy as np
import torch

from flatnav_tpu_torch.bench import _northstar as ns
from flatnav_tpu_torch.data_type import host_tensor, resolve_device
from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fused_knn
from flatnav_tpu_torch.ops import fused_scan as fs
from flatnav_tpu_torch.quantization.pq import pack_codes_lanes, pq_scan_knn

D, NQ, K = 128, 8192, 10
N = 100_000_000
SEED = 0x100E
TARGET = 0.95
#: rows a generator chunk, a table upload and an encode call take
CHUNK = 2_000_000
#: queries a call of the exact engine (and of the ground truth)
EXACT_BATCH = 2048
PQ_RERANKS = (128, 256, 512)
PQ4_RERANKS = (128, 256, 512, 1024)

log = ns.logger("100m")


def _q8(x, lo, scale):
    return np.clip(np.round((x - lo) * scale), 0, 255).astype(np.uint8)


def _write_chunk(path: str, n: int, i: int, centers, lo, scale) -> None:
    """Chunk `i` of the data, from its own child RNG, into the memmap."""
    start = i * CHUNK
    crng = np.random.default_rng((SEED, 1, i))
    rows = min(CHUNK, n - start)
    assign = crng.integers(0, centers.shape[0], rows)
    blk = centers[assign] + crng.standard_normal((rows, D)).astype(np.float32)
    mm = np.memmap(path, np.uint8, "r+", shape=(n, D))
    mm[start : start + rows] = _q8(blk, lo, scale)
    mm.flush()


def gen_dataset(n: int, centers_per_64k: int = 26, rebuild: bool = False, nq: int = NQ,
                workers: int = 1):
    """-> (data: read-only [n, D] uint8 memmap, queries: [nq, D] uint8).

    The JAX runner's generator (benchmarks/run_bigann_100m.py:gen_dataset)
    byte for byte: a Gaussian mixture of max(8, n * centers_per_64k / 65536)
    centres, quantised to uint8 by the 0.5 / 99.5 percentiles of a 1M-row
    sample, in 2M-row chunks with child seeds (SEED, 1, i); queries are
    dataset rows perturbed in the unquantised space. Files live under the
    scratch directory and are reused unless `rebuild`. `workers` processes
    write chunks in parallel; the bytes do not depend on it."""
    scratch = ns.scratch()
    ctag = "" if centers_per_64k == 26 else f"_c{centers_per_64k}"
    path = f"{scratch}/100m_data_{n}_{D}{ctag}.u8"
    qpath = f"{scratch}/100m_q_{n}_{D}{ctag}.u8"
    if os.path.exists(path) and os.path.exists(qpath) and not rebuild:
        qs = np.fromfile(qpath, np.uint8).reshape(-1, D)
        if len(qs) >= nq:
            return np.memmap(path, np.uint8, "r", shape=(n, D)), qs[:nq]
        log(f"query file has {len(qs)} < {nq} rows; regenerating")
    rng = np.random.default_rng(SEED)
    n_centers = max(8, (n * centers_per_64k) // 65536)
    centers = rng.standard_normal((n_centers, D)).astype(np.float32) * 0.7
    s_assign = rng.integers(0, n_centers, 1_000_000)
    sample = centers[s_assign] + rng.standard_normal((1_000_000, D)).astype(np.float32)
    lo, hi = np.percentile(sample, [0.5, 99.5])
    scale = 255.0 / (hi - lo)
    del sample
    np.memmap(path + ".tmp", np.uint8, "w+", shape=(n, D)).flush()
    t0 = time.perf_counter()
    jobs = [(path + ".tmp", n, i, centers, lo, scale) for i in range(-(-n // CHUNK))]
    if workers > 1 and len(jobs) > 1:
        with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            pool.starmap(_write_chunk, jobs, chunksize=1)
    else:
        for job in jobs:
            _write_chunk(*job)
    os.replace(path + ".tmp", path)
    qrng = np.random.default_rng((SEED, 2))
    data = np.memmap(path, np.uint8, "r", shape=(n, D))
    qsrc = qrng.choice(n, nq, replace=False)
    qf = data[np.sort(qsrc)].astype(np.float32)
    # undo the quantisation to perturb in the original space, then requantise
    qf = qf / scale + lo + qrng.standard_normal((nq, D)).astype(np.float32)
    queries = _q8(qf, lo, scale)
    queries.tofile(qpath)
    log(f"dataset generated in {time.perf_counter() - t0:.1f} s "
        f"({os.path.getsize(path) / 1e9:.1f} GB, {workers} workers)")
    return data, queries


def push_resident(data_mm, dev: torch.device) -> torch.Tensor:
    """The memmap as one [n, D] uint8 tensor on `dev`, `CHUNK` rows an
    upload."""
    n = data_mm.shape[0]
    table = torch.empty((n, D), dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    for start in range(0, n, CHUNK):
        table[start : start + CHUNK] = host_tensor(data_mm[start : start + CHUNK]).to(dev)
    ns.sync(dev)
    log(f"table resident: {n}x{D} uint8 ({n * D / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return table


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--nq", type=int, default=NQ)
    ap.add_argument("--b", type=int, default=8192,
                    help="queries a fused_knn call (it chunks them itself)")
    ap.add_argument("--pq-b", type=int, default=1024, help="queries a pq_scan_knn call")
    ap.add_argument("--pq-nq", type=int, default=None,
                    help="queries the PQ engines take, the first of --nq (default all)")
    ap.add_argument("--rerank", type=int, default=32)
    ap.add_argument("--m-pq", type=int, default=16, help="8-bit subquantizers")
    ap.add_argument("--m-pq4", type=int, default=32,
                    help="subquantizers of the 4-bit point (m_pq4/2 code bytes a node)")
    ap.add_argument("--pq-rerank", type=int, default=64)
    ap.add_argument("--pq-tile", type=int, default=32768, help="ADC scan tile")
    ap.add_argument("--no-pq", action="store_true")
    ap.add_argument("--pq-only", action="store_true", help="skip the fused and exact engines")
    ap.add_argument("--skip-exact", action="store_true")
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1),
                    help="generator processes")
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
    n, nq = args.n, args.nq
    kernel_build_s = ns.build_kernels(dev)
    run_start = ns.launches()
    data_mm, queries = gen_dataset(n, rebuild=args.rebuild, nq=nq, workers=args.workers)
    table = push_resident(data_mm, dev)
    q_dev = torch.from_numpy(queries).to(dev)

    def batches(fn, batch):
        return lambda: np.concatenate([fn(q_dev[lo : lo + batch]).cpu().numpy()
                                       for lo in range(0, nq, batch)])

    run_exact = batches(lambda q: brute_force_knn(table, q, K, MetricType.L2, n_valid=n)[1],
                        EXACT_BATCH)
    gt_path = f"{ns.scratch()}/100m_gt_{n}_{D}.npy"
    gt_made = not os.path.exists(gt_path) or args.rebuild
    t0 = time.perf_counter()
    gt = ns.ground_truth(table, q_dev, K, MetricType.L2, gt_path, args.rebuild, EXACT_BATCH,
                         n_valid=n)
    if gt_made:
        log(f"ground truth in {time.perf_counter() - t0:.1f} s")

    results = {}
    if not args.pq_only:
        ns.reset_peak(dev)
        for name, exact_rerank in (("fused", True), ("fusednr", False)):
            results[f"{name}_engine"] = ns.scan_point(
                batches(lambda q, e=exact_rerank: fused_knn(
                    table, q, K, MetricType.L2, rerank=args.rerank, n_valid=n,
                    exact_rerank=e)[1], args.b), gt, dev, n, D)
            log(f"{name} engine: {results[f'{name}_engine']['qps']:.0f} qps @ recall "
                f"{results[f'{name}_engine']['recall']:.4f}")
        results["scan_peak_bytes"] = ns.peak_bytes(dev)
        L, t, _, qc = fs._pick_shapes(n, min(args.b, nq), D, 1, fs._TILE, fs._QB, None,
                                      fs._SUMMARY_BYTES)
        results["fused_shapes"] = {"L": L, "T": t, "query_chunk": qc,
                                   "summary_bytes": qc * (-(-n // t) * (t // L)) * 8}
        # K1 alone at the fused engine's first query chunk (not counted above)
        results["kernels"] = {"scan_buckets": ns.k1_times(table, q_dev[: args.b], MetricType.L2)}
        if not args.skip_exact:
            # the ground truth was this engine's warm-up call where it was made here
            results["exact_engine"] = ns.scan_point(run_exact, gt, dev, n, D,
                                                    warm=gt if gt_made else None)
            log(f"exact engine: {results['exact_engine']['qps']:.0f} qps")

    if not args.no_pq:
        results.update(_pq_engines(args, data_mm, queries, q_dev, table, gt, dev))

    pq_nq = min(args.pq_nq or nq, nq)
    cuts = ["PQ engines skipped (--no-pq)" if args.no_pq else "",
            f"PQ engines: the first {pq_nq} queries of the source's {NQ}"
            if pq_nq < nq and not args.no_pq else "",
            "fused and exact engines skipped (--pq-only)" if args.pq_only else "",
            "exact engine skipped (--skip-exact)" if args.skip_exact and not args.pq_only else ""]
    out = {
        "workload": f"clustered-c26 uint8 {n}x{D} L2 k={K} (one card)",
        "note": "BigANN-100M-class stand-in (no egress). The uint8 table is resident on the "
                "card; the fused engine scans it unpromoted (exact integer phase-1 keys). No "
                "graph or reference baseline at this N, as in the JAX runner.",
        "batch": args.b,
        "fused_autoshaped": True,
        "device": device,
        "reduced": ns.reduced(n, N, nq, NQ, args.why, *cuts),
        "kernel_build_seconds": kernel_build_s,
        "launches": ns.launch_delta(run_start),
        **results,
    }
    size_tag = "" if n == N else f"_n{n}"
    path = ns.write_results(out, f"results_bigann_100m_class{size_tag}.json", args.results_dir)
    log(f"wrote {os.path.relpath(path)}")
    print(json.dumps(out))
    return out


def _pq_engines(args, data_mm, queries, q_dev, table, gt, dev) -> dict:
    """-> {"pq_scan_engine": ..., "pq4_scan_engine": ...}: each quantizer
    trained on a 500k-row stride sample, its codes lane-packed, and its
    raw-rerank width swept to the target."""
    n = data_mm.shape[0]
    nq = min(args.pq_nq or queries.shape[0], queries.shape[0])
    qf, gt = queries[:nq].astype(np.float32), gt[:nq]
    sample = np.ascontiguousarray(data_mm[:: max(1, n // 500_000)][:500_000]).astype(np.float32)

    def run(pq, codes_dev, rr, nbits):
        def go():
            res = []
            for lo in range(0, nq, args.pq_b):
                tables = pq.adc_tables(qf[lo : lo + args.pq_b])
                _, ids = pq_scan_knn(codes_dev, tables, K, metric=MetricType.L2,
                                     tile_size=args.pq_tile, rerank=rr,
                                     packed_4bit=nbits == 4, lane_packed=True, n_valid=n,
                                     vectors=table, queries=q_dev[lo : lo + args.pq_b])
                res.append(ids.cpu().numpy())
            return np.concatenate(res)
        return go

    out = {}
    for key, m_pq, nbits, widths in (("pq_scan_engine", args.m_pq, 8, PQ_RERANKS),
                                     ("pq4_scan_engine", args.m_pq4, 4, PQ4_RERANKS)):
        out[key] = ns.pq_scan_point(
            D, m_pq, nbits, sample,
            lambda pq, nbits=nbits: ns.encode_chunks(pq, data_mm, dev, CHUNK, pack=nbits == 4),
            lambda codes: torch.from_numpy(pack_codes_lanes(codes, args.pq_tile)[0]).to(dev),
            lambda pq, codes_dev, rr, nbits=nbits: run(pq, codes_dev, rr, nbits),
            (args.pq_rerank, *widths), TARGET, gt, dev, key, log)[0]
    return out


__all__ = ["gen_dataset", "main", "push_resident"]

if __name__ == "__main__":
    main()
