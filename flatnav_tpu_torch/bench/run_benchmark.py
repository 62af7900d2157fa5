"""Benchmark runner CLI.

Counterpart of flatnav_tpu/bench/run_benchmark.py (the reference harness,
experiments/run-benchmark.py: 362-506 argparse surface, 160-262
train_index, 38-124 compute_metrics): for each (M, ef_construction) build an
index, optionally reorder, then sweep ef_search computing the registered
metrics; results append to a metrics JSON and can be rendered as recall-QPS
Pareto plots (plotting.py).

Queries run in device batches (`--batch-size` replaces the reference's
`--num-search-threads`). The index lives on the CUDA card unless
`--device cpu` is given; without a card and without that flag the run
raises. `--index-type hnsw` (the hnswlib comparison baseline) needs the
hnswlib wheel and raises ImportError without it.

Usage:
  python -m flatnav_tpu_torch.bench.run_benchmark \
      --dataset train.npy --queries q.npy --gtruth gt.npy \
      --metric l2 --num-node-links 32 \
      --ef-construction 100 --ef-search 100 200 500 --k 10
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from flatnav_tpu_torch.bench.data_loader import get_data_loader
from flatnav_tpu_torch.bench.metrics import MetricContext, metric_manager

logger = logging.getLogger("flatnav_tpu_torch.bench")

DEFAULT_METRICS = [
    "recall",
    "qps",
    "latency_p50",
    "latency_p90",
    "latency_p95",
    "latency_p99",
    "latency_p999",
    "distance_computations",
    "index_size",
    "build_time",
]


class HnswAdapter:
    """Adapter giving an hnswlib.Index the Index surface the metric registry
    drives: search/ef handling, distance-computation and memory stats
    (reference run-benchmark.py:79-124 uses knn_query + set_ef; the forked
    hnswlib adds get_distance_computations)."""

    def __init__(self, hnsw, dim: int, m: int, dataset_size: int):
        self._hnsw = hnsw
        self._dim = dim
        self._m = m
        self._n = dataset_size

    def search(self, queries, K: int, ef_search: int):
        self._hnsw.set_ef(max(ef_search, K))
        labels, dists = self._hnsw.knn_query(np.asarray(queries), k=K)
        return dists, labels

    def get_query_distance_computations(self) -> int:
        # the forked hnswlib's getter drains on read, same semantics as
        # Index (the reference sums per-query reads,
        # experiments/run-benchmark.py:95-98)
        getter = getattr(self._hnsw, "get_distance_computations", None)
        return int(getter()) if getter is not None else 0

    def index_memory_bytes(self) -> int:
        # hnswlib layout: data + level0 links (2M) + upper-level links,
        # approximated as the reference does for its memory comparison
        per_node = self._dim * 4 + 4 * (2 * self._m) + 8
        return per_node * self._n

    def reorder(self, strategies):
        raise NotImplementedError("hnswlib baseline has no reordering")


class ScanAdapter:
    """Presents Index.search_exact (the exact scan / the two-phase scans)
    through the harness's `search(queries, K, ef_search)` contract;
    ef_search is accepted and ignored (a scan has no beam). All other
    attributes delegate to the underlying Index."""

    def __init__(self, index, rerank: int, fused: bool = True,
                 exact_rerank: bool = True):
        self._index = index
        self._rerank = rerank
        self._fused = fused
        self._exact_rerank = exact_rerank

    def search(self, queries, K: int, ef_search: int):
        del ef_search
        return self._index.search_exact(
            queries, K, rerank=self._rerank, fused=self._fused,
            exact_rerank=self._exact_rerank,
        )

    def __getattr__(self, name):
        return getattr(self._index, name)


class PQScanAdapter:
    """Presents the PQ-ADC one-hot scan (quantization.pq.pq_scan_knn,
    raw-vector rerank) through the harness's `search(queries, K,
    ef_search)` contract; ef_search is accepted and ignored. The
    allocate-only Index supplies the raw vectors for the shortlist rerank;
    the PQ codes are what the scan reads."""

    def __init__(self, index, pq, codes, rerank: int = 64):
        self._index = index
        self._pq = pq
        self._codes = codes
        self._rerank = rerank
        self._dc = 0

    def search(self, queries, K: int, ef_search: int):
        del ef_search
        from flatnav_tpu_torch.quantization.pq import pq_scan_knn

        g = self._index.graph  # allocate-only index: vectors valid
        q = torch.from_numpy(
            np.ascontiguousarray(queries, dtype=np.float32)
        ).to(g.device)
        d, ids = pq_scan_knn(
            self._codes, self._pq.adc_tables(q), K, metric=self._pq.metric,
            rerank=self._rerank, n_valid=g.num_nodes,
            vectors=g.vectors, queries=q,
        )
        # the ADC scan scores every committed code per query, plus the
        # raw-vector rerank of the shortlist
        self._dc += queries.shape[0] * (g.num_nodes + self._rerank)
        # the copies to the host end the dispatch, as Index.search's do
        return d.cpu().numpy(), ids.cpu().numpy()

    def get_query_distance_computations(self) -> int:
        total, self._dc = self._dc, 0
        return total

    def __getattr__(self, name):
        return getattr(self._index, name)


def _hnswlib():
    try:
        import hnswlib  # optional comparison baseline
    except ImportError as e:
        raise ImportError(
            "--index-type hnsw and --use-hnsw-base-layer need the hnswlib "
            "package, which is not installed"
        ) from e
    return hnswlib


def train_index(
    train_data: np.ndarray,
    metric: str,
    dim: int,
    dataset_size: int,
    m: int,
    ef_construction: int,
    index_type: str = "flatnav",
    data_type: str = "float32",
    num_build_threads: int = 1,
    use_hnsw_base_layer: bool = False,
    hnsw_base_layer_filename: str | None = None,
    device=None,
):
    """Build an index (run-benchmark.py:160-262) -> (index, build seconds)."""
    if index_type == "hnsw":
        hnsw = _hnswlib().Index(space="l2" if metric == "l2" else "ip", dim=dim)
        hnsw.init_index(
            max_elements=dataset_size, ef_construction=ef_construction, M=m
        )
        hnsw.set_num_threads(num_build_threads)
        t0 = time.perf_counter()
        hnsw.add_items(train_data, ids=np.arange(dataset_size))
        return HnswAdapter(hnsw, dim, m, dataset_size), time.perf_counter() - t0

    import flatnav_tpu_torch
    from flatnav_tpu_torch.data_type import DataType

    index = flatnav_tpu_torch.index.create(
        distance_type=metric,
        dim=dim,
        dataset_size=dataset_size,
        max_edges_per_node=m,
        index_data_type=DataType(data_type),
        collect_stats=True,
        device=device,
    )

    def done(result):
        # the build's seconds end when the card has finished its work
        if index.device.type == "cuda":
            torch.cuda.synchronize(index.device)
        return result, time.perf_counter() - t0

    t0 = time.perf_counter()
    if index_type in ("flatnav-exact", "flatnav-fast", "flatnav-fused",
                      "flatnav-fusednr"):
        # scan engines need only the vectors: allocate without edges
        # (the reference's allocateNode path, bindings.cpp:308-324)
        index.allocate_nodes(train_data)
        rerank = 0 if index_type == "flatnav-exact" else 32
        fused = index_type.startswith("flatnav-fused")
        return done(ScanAdapter(
            index, rerank, fused=fused,
            exact_rerank=index_type != "flatnav-fusednr",
        ))
    if index_type == "flatnav-pq-scan":
        # PQ-ADC scan: train PQ + encode is the "build" (the reference's
        # flatnav_pq tool role); raw vectors kept for shortlist rerank
        from flatnav_tpu_torch.quantization import ProductQuantizer

        index.allocate_nodes(train_data)
        f32 = np.asarray(train_data, dtype=np.float32)
        # largest subquantizer count <= 16 that divides dim
        n_sub = max(s for s in range(1, min(16, dim) + 1) if dim % s == 0)
        pq = ProductQuantizer(
            dim=dim, num_subquantizers=n_sub, metric=index.metric,
            device=index.device,
        ).train(f32[:200_000], n_iters=20)
        return done(PQScanAdapter(index, pq, pq.encode(f32)))
    if use_hnsw_base_layer:
        # hnswlib base-layer import path (run-benchmark.py:204-239)
        hnsw = _hnswlib().Index(space="l2" if metric == "l2" else "ip", dim=dim)
        hnsw.init_index(
            max_elements=dataset_size, ef_construction=ef_construction, M=m // 2
        )
        hnsw.set_num_threads(num_build_threads)
        hnsw.add_items(train_data, ids=np.arange(dataset_size))
        hnsw.save_base_layer_graph(filename=hnsw_base_layer_filename)
        index.allocate_nodes(train_data)
        index.build_graph_links(hnsw_base_layer_filename)
        os.remove(hnsw_base_layer_filename)
    else:
        index.add(train_data, ef_construction=ef_construction)
    return done(index)


def compute_metrics(
    requested_metrics,
    index,
    queries,
    ground_truth,
    ef_search: int,
    k: int,
    batch_size: int,
    build_seconds: float,
) -> dict:
    """Timed search + metric registry (run-benchmark.py:38-124).

    One untimed warm-up batch runs first: the first dispatch pays the
    kernels' build and load, the matmul library's start-up and the
    allocator's first growth, which would otherwise land in qps and the
    latency tail. Latencies are per-dispatch wall times, by the host clock
    around a `search` that ends in a copy to the host: every query in a
    batch waits for its whole dispatch, so each batch's wall time enters
    the percentile sample once per query it carried, NOT divided by the
    batch size, which would amortize p999 down to p50 (the reference times
    one query per call, run-benchmark.py:67-75; --batch-size 1 reproduces
    that protocol exactly)."""
    nq = queries.shape[0]
    index.search(queries[:batch_size], K=k, ef_search=ef_search)  # warm-up
    index.get_query_distance_computations()  # reset (incl. the warm-up's)
    latencies = []
    found = np.empty((nq, k), np.int64)
    t0 = time.perf_counter()
    for lo in range(0, nq, batch_size):
        tb = time.perf_counter()
        _, labels = index.search(
            queries[lo : lo + batch_size], K=k, ef_search=ef_search
        )
        found[lo : lo + labels.shape[0]] = labels
        latencies.extend([time.perf_counter() - tb] * labels.shape[0])
    total = time.perf_counter() - t0
    ctx = MetricContext(
        index=index,
        found_labels=found,
        ground_truth=ground_truth,
        latencies_s=np.asarray(latencies),
        total_seconds=total,
        num_queries=nq,
        distance_computations=index.get_query_distance_computations(),
        build_seconds=build_seconds,
    )
    return metric_manager.compute(requested_metrics, ctx)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Benchmark flatnav_tpu_torch on ANN benchmark datasets"
    )
    p.add_argument("--dataset", required=True, help="train vectors file")
    p.add_argument("--queries", required=True)
    p.add_argument("--gtruth", required=True)
    p.add_argument("--metric", default="l2", choices=["l2", "angular"])
    p.add_argument("--dataset-size", type=int, default=None, help="row limit")
    p.add_argument(
        "--index-type", default="flatnav",
        choices=["flatnav", "flatnav-exact", "flatnav-fast",
                 "flatnav-fused", "flatnav-fusednr", "flatnav-pq-scan",
                 "hnsw"],
    )
    p.add_argument("--data-type", default="float32")
    p.add_argument("--num-node-links", type=int, nargs="+", default=[32])
    p.add_argument("--ef-construction", type=int, nargs="+", default=[100])
    p.add_argument("--ef-search", type=int, nargs="+", default=[100])
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--num-build-threads", type=int, default=1)
    p.add_argument("--use-hnsw-base-layer", action="store_true")
    p.add_argument("--hnsw-base-layer-filename", default="hnsw_base.mtx")
    p.add_argument("--reordering-strategies", nargs="*", default=None)
    p.add_argument("--metrics-file", default="metrics.json")
    p.add_argument("--metrics", nargs="+", default=DEFAULT_METRICS)
    p.add_argument("--no-plot", action="store_true")
    p.add_argument(
        "--memory-log", default=None,
        help="sample host+device memory to this JSONL during the run "
             "(the reference's cAdvisor/Prometheus analog)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device of the index (default: the CUDA card; 'cpu' "
             "runs every kernel's plain version)",
    )
    return p.parse_args(argv)


def run_experiment(args) -> list[dict]:
    if args.memory_log:
        from flatnav_tpu_torch.utils.profiling import MemoryMonitor

        with MemoryMonitor(args.memory_log) as mon:
            rows = _run_experiment(args)
        logger.info("memory peaks: %s", mon.peak())
        return rows
    return _run_experiment(args)


def _run_experiment(args) -> list[dict]:
    loader = get_data_loader(
        args.dataset, args.queries, args.gtruth, limit=args.dataset_size
    )
    train, queries, gtruth = loader.load_data()
    n, dim = train.shape
    all_rows = []
    for m in args.num_node_links:
        for efc in args.ef_construction:
            logger.info("building: M=%d ef_construction=%d n=%d", m, efc, n)
            index, build_s = train_index(
                train,
                args.metric,
                dim,
                n,
                m,
                efc,
                index_type=args.index_type,
                data_type=args.data_type,
                num_build_threads=args.num_build_threads,
                use_hnsw_base_layer=args.use_hnsw_base_layer,
                hnsw_base_layer_filename=args.hnsw_base_layer_filename,
                device=args.device,
            )
            if args.reordering_strategies:
                index.reorder(args.reordering_strategies)
            for efs in args.ef_search:
                row = compute_metrics(
                    args.metrics,
                    index,
                    queries,
                    gtruth,
                    ef_search=efs,
                    k=args.k,
                    batch_size=args.batch_size,
                    build_seconds=build_s,
                )
                row.update(
                    dataset=os.path.basename(args.dataset),
                    index_type=args.index_type,
                    M=m,
                    ef_construction=efc,
                    ef_search=efs,
                    k=args.k,
                )
                logger.info("result: %s", row)
                all_rows.append(row)
                _append_metrics(args.metrics_file, row)
    return all_rows


def _append_metrics(path: str, row: dict):
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)
    rows.append(row)
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)


def main(argv=None) -> list[dict]:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    rows = run_experiment(args)
    if not args.no_plot:
        try:
            from flatnav_tpu_torch.bench.plotting import plot_pareto

            plot_pareto(
                rows, out_path=os.path.splitext(args.metrics_file)[0] + ".png"
            )
        except ImportError as e:  # matplotlib is optional
            logger.warning("plotting skipped: %s", e)
    return rows


if __name__ == "__main__":
    main()
