"""What the north-star runners share (`bench/northstar.py`,
`bench/bigann_10m.py`, `bench/bigann_100m.py`).

  * `scratch()`: the directory of build checkpoints, cached ground truth and
    generated data: `FLATNAV_SCRATCH`, else `.scratch/` at the repository
    root (git-ignored), read at call time.
  * `build_kernels`: nvcc for every kernel before any clock starts; its
    seconds are the results' `kernel_build_seconds`, outside every time.
  * `build_checkpointed`: rows go in by chunks through `add_batch` over a
    graph from `make_empty_graph`; the index is saved after every chunk and
    a later run resumes from that file. The build clock stops at a device
    synchronise after each chunk and leaves the save out.
  * `ground_truth`: `brute_force_knn` ids, cached as `.npy`.
  * `time_engine` / `scan_point`: one untimed warm-up call, whose ids give
    the recall, then the best of 3 timed calls. Every call ends with its ids
    copied to the host, and the clock starts and stops after
    `torch.cuda.synchronize()`. A scan point adds `achieved_tflops` (2 N d
    operations a query) and `mfu` against the H100's dense bf16 peak
    (`measure.BF16_FLOP_PER_S`, 989 TFLOP/s). Each point carries the kernel
    launches its four calls made (`launches` / `launch_delta`: the counts
    since a reading).
  * `pq_scan_point` / `rerank_sweep` / `encode_chunks`: a PQ scan engine
    (train, encode, and its raw-rerank width sweep), its codes encoded on the
    device a chunk of rows at a time; the runners keep their packing and
    scan options.
  * `k1_times` / `k2_times`: a kernel alone at the shapes a runner gives it,
    beside its plain version, its bound and (K1) a bf16 `torch.matmul` of
    the same product (and `torch._int_mm` on 8-bit tables), by CUDA events
    (`measure.timed`); None on the CPU.
  * `reduced`: what a run cut against the source's configuration, for the
    results file's `reduced` key.
  * `write_results`: the results file, under `bench/results/` unless the
    caller names another directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.bench.measure import (
    BF16_FLOP_PER_S,
    CallRecorder,
    card,
    gather_bound,
    scan_bound,
    timed,
)
from flatnav_tpu_torch.bench.metrics import recall_at_k
from flatnav_tpu_torch.data_type import host_tensor
from flatnav_tpu_torch.index import search as search_mod
from flatnav_tpu_torch.index.build import add_batch
from flatnav_tpu_torch.index.graph import make_empty_graph
from flatnav_tpu_torch.index.serialize import load_index, save_index
from flatnav_tpu_torch.quantization import ProductQuantizer
from flatnav_tpu_torch.quantization.pq import pack_codes_4bit
from flatnav_tpu_torch.ops import MetricType, brute_force_knn
from flatnav_tpu_torch.ops import fused_scan as fs
from flatnav_tpu_torch.ops.distances import squared_norms
from flatnav_tpu_torch.ops.gather_distance import gather_distances, gather_distances_plain
from flatnav_tpu_torch.utils.profiling import device_memory_stats

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
#: the timed calls of an engine point, after its warm-up
REPEATS = 3


def scratch() -> str:
    path = os.environ.get("FLATNAV_SCRATCH", os.path.join(REPO, ".scratch"))
    os.makedirs(path, exist_ok=True)
    return path


def logger(tag: str):
    def log(msg):
        print(f"[{tag}] {msg}", file=sys.stderr, flush=True)
    return log


def device_line(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    return card() if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int | None:
    """Peak device bytes allocated since the last reset; None on the CPU."""
    return device_memory_stats(dev).get("peak_bytes_in_use")


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def launches() -> dict:
    return {"scan_buckets": fs.scan_buckets.launches,
            "scan_buckets_variants": dict(fs.scan_buckets.variants),
            "gather_distances": gather_distances.launches}


def launch_delta(before: dict) -> dict:
    now = launches()
    return {"scan_buckets": now["scan_buckets"] - before["scan_buckets"],
            "scan_buckets_variants": {v: now["scan_buckets_variants"][v] - n
                                      for v, n in before["scan_buckets_variants"].items()},
            "gather_distances": now["gather_distances"] - before["gather_distances"]}


def build_kernels(dev: torch.device) -> float | None:
    """Build every CUDA kernel before any clock starts (nvcc would otherwise
    run at the first launch, inside the first timed build chunk). -> its
    seconds (0.0 where the libraries exist), None on the CPU."""
    if dev.type != "cuda":
        return None
    t0 = time.perf_counter()
    _build.build()
    return round(time.perf_counter() - t0, 1)


def build_checkpointed(data, *, cache: str, capacity: int, m: int, efc: int,
                       metric: MetricType, dtype: torch.dtype, chunk: int,
                       dev: torch.device, rebuild: bool, log, **add_kw):
    """Insert `data` (numpy, [n, d]) with labels 0..n-1 by chunks of
    `chunk` rows, saving the index to `cache` after each; resumes from
    `cache` unless `rebuild`. -> (graph, build seconds, peak device bytes of
    this run's chunks or None, the kernel launches of its chunks)."""
    n, d = data.shape
    if os.path.exists(cache) and not rebuild:
        g, _, meta = load_index(cache, device=dev)
        build_s, done = float(meta.get("build_seconds", 0.0)), g.num_nodes
        if g.capacity < capacity:
            raise ValueError(f"checkpoint capacity {g.capacity} < {capacity}")
        log(f"resuming checkpoint {cache}: {done} nodes, {build_s:.1f} s build so far")
    else:
        g = make_empty_graph(capacity, d, m, dtype=dtype, device=dev)
        build_s, done = 0.0, 0
    reset_peak(dev)
    before = launches()
    while done < n:
        hi = min(done + chunk, n)
        sync(dev)
        t0 = time.perf_counter()
        add_batch(g, data[done:hi], np.arange(done, hi), ef_construction=efc, metric=metric,
                  **add_kw)
        sync(dev)
        build_s += time.perf_counter() - t0
        done = hi
        save_index(cache, g, metric, extra={"build_seconds": build_s})
        log(f"built {done}/{n} ({build_s:.1f} s cumulative)")
    return g, build_s, peak_bytes(dev), launch_delta(before)


def ground_truth(table: torch.Tensor, queries: torch.Tensor, k: int, metric: MetricType,
                 path: str, rebuild: bool, batch: int, n_valid: int | None = None) -> np.ndarray:
    """[nq, k] exact ids by `brute_force_knn`, `batch` queries a call;
    cached at `path` unless `rebuild`."""
    if os.path.exists(path) and not rebuild:
        return np.load(path)
    gt = np.concatenate([
        brute_force_knn(table, queries[lo : lo + batch], k, metric, n_valid=n_valid)[1].cpu().numpy()
        for lo in range(0, queries.shape[0], batch)
    ])
    np.save(path, gt)
    return gt


def recall(found: np.ndarray, gt: np.ndarray) -> float:
    return float(recall_at_k(found, gt))


def time_engine(run, gt: np.ndarray, dev: torch.device, warm: np.ndarray | None = None) -> dict:
    """`run()` -> [nq, k] ids on the host. One untimed warm-up call gives
    the recall (`warm`: the ids of a warm-up call already made); the rate is
    nq over the fastest of `REPEATS` timed calls."""
    before = launches()
    r = recall(run() if warm is None else warm, gt)
    times = []
    for _ in range(REPEATS):
        sync(dev)
        t0 = time.perf_counter()
        run()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return {"recall": r, "qps": round(gt.shape[0] / min(times), 1),
            "launches": launch_delta(before)}


def scan_point(run, gt: np.ndarray, dev: torch.device, n: int, d: int,
               warm: np.ndarray | None = None) -> dict:
    """`time_engine` plus the scan's rate in operations: 2 N d a query."""
    out = time_engine(run, gt, dev, warm)
    tf = out["qps"] * 2.0 * n * d / 1e12
    out["achieved_tflops"] = round(tf, 2)
    out["mfu"] = round(tf / (BF16_FLOP_PER_S / 1e12), 4)
    return out


def rerank_sweep(make_run, widths, target: float, gt: np.ndarray, dev: torch.device, name: str,
                 log) -> dict:
    """The shortlist width sweep of a PQ engine: `make_run(width)` timed at
    each of `widths` (repeats dropped) to the first whose recall meets
    `target`; else the best point."""
    best = None
    for rr in dict.fromkeys(widths):
        pt = time_engine(make_run(rr), gt, dev)
        pt["rerank"] = rr
        log(f"{name} rerank={rr}: {pt['qps']:.0f} qps @ recall {pt['recall']:.4f}")
        if best is None or (pt["recall"], pt["qps"]) > (best["recall"], best["qps"]):
            best = pt
        if pt["recall"] >= target:
            return pt
    return best


def pq_scan_point(d: int, m_pq: int, nbits: int, sample: np.ndarray, encode, place, make_run,
                  widths, target: float, gt: np.ndarray, dev: torch.device, name: str, log):
    """A PQ scan engine's point: a quantizer of `m_pq` subspaces at `nbits`
    trained on `sample` (25 Lloyd iterations), `encode(pq)` -> its codes on
    the host (the prep clock stops here), `place(codes)` -> the tensor the
    scan reads, then `rerank_sweep` of `make_run(pq, placed, width)` over
    `widths`. -> (point, pq, placed)"""
    sync(dev)
    t0 = time.perf_counter()
    pq = ProductQuantizer(d, m_pq, nbits=nbits, device=dev).train(sample, n_iters=25)
    codes = encode(pq)
    prep = time.perf_counter() - t0
    log(f"PQ nbits={nbits} train+encode: {prep:.1f} s ({codes.nbytes / 1e9:.2f} GB codes)")
    placed = place(codes)
    del codes
    best = rerank_sweep(lambda rr: make_run(pq, placed, rr), widths, target, gt, dev, name, log)
    best.update(prep_seconds=round(prep, 1), code_bytes_per_node=m_pq * nbits // 8)
    if nbits == 4:
        best["nbits"] = 4
    return best, pq, placed


def encode_chunks(pq, rows, dev, chunk: int, pack: bool = False) -> np.ndarray:
    """PQ codes of `rows` (uint8 numpy or memmap), `chunk` rows at a time
    cast to float32 on `dev`; nibble-packed with `pack`."""
    out = []
    for lo in range(0, rows.shape[0], chunk):
        blk = host_tensor(rows[lo : lo + chunk]).to(dev).float()
        c = pq.encode(blk)
        out.append((pack_codes_4bit(c) if pack else c).cpu().numpy())
    return np.concatenate(out)


def k1_times(dataset: torch.Tensor, queries: torch.Tensor, metric: MetricType,
             n_valid: int | None = None, also: tuple[str, ...] = ()) -> dict | None:
    """K1 (`scan_buckets`) alone at the shapes and operands `fused_knn` gives
    it for these arguments (its first query chunk), with the variant it
    takes, beside its plain version, its bound and a bf16 `torch.matmul` of
    the same product (in row chunks of at most 2 GiB of output); for 8-bit
    queries of 8-bit tables also `torch._int_mm` (s8 x s8 -> s32; uint8
    operands shifted by 128, which is the same work); and, in `also_ms`,
    the kernel launched through its C entry as each variant `also` names
    (e.g. "mma" beside "wgmma_mixed"). 8-bit tables against 8-bit or
    integer-valued queries must be bit-equal to the plain version;
    `key_max`, the largest finite key, scales the tolerance of the others,
    and `ids_equal` is the share of buckets whose ids agree. These launches
    are not counted on the runner's path. None on the CPU."""
    if not dataset.is_cuda:
        return None
    saved = launches()
    n, d = dataset.shape
    rows, q_all = fs.scan_operands(dataset, queries)
    L, t, _, qc = fs._pick_shapes(n, queries.shape[0], d, rows.element_size(), fs._TILE,
                                  fs._QB, None, fs._SUMMARY_BYTES)
    pen = (squared_norms(rows[:, :d]) if metric == MetricType.L2
           else torch.zeros(n, dtype=torch.float32, device=rows.device))
    q = q_all[:qc].contiguous()
    del q_all
    nlim = min(n if n_valid is None else int(n_valid), n)
    native = rows.dtype in (torch.uint8, torch.int8)
    exact = fs.exact_keys(q, rows)
    kmin, kid = fs.scan_buckets(q, rows, pen, nlim, t, L)
    pmin, pid = fs.scan_buckets_plain(q, rows, pen, nlim, t, L)
    fin = torch.isfinite(pmin)
    if not torch.equal(fin, torch.isfinite(kmin)):
        raise RuntimeError("K1 and its plain version disagree on which buckets are empty")
    err = float((kmin[fin] - pmin[fin]).abs().max()) if bool(fin.any()) else 0.0
    key_max = float(pmin[fin].abs().max()) if bool(fin.any()) else 0.0
    ids_equal = float((kid == pid).float().mean())
    if exact and not (torch.equal(kmin, pmin) and torch.equal(kid, pid)):
        raise RuntimeError("K1 is not bit-equal to its plain version on 8-bit rows")
    del kmin, kid, pmin, pid
    ms = timed(lambda: fs.scan_buckets(q, rows, pen, nlim, t, L), reps=3, warmup=1)
    nb = -(-n // t) * (t // L)
    also_ms = {}
    for variant in also:
        q_v = q.to(torch.bfloat16) if variant in fs._BF16_QUERIES else q
        om = torch.empty((qc, nb), dtype=torch.float32, device=rows.device)
        oi = torch.empty((qc, nb), dtype=torch.int32, device=rows.device)
        also_ms[variant] = timed(lambda: _build.check(
            fs.launch_as(variant, q_v, rows, pen, nlim, t, L, om, oi), f"K1 as {variant}"),
            reps=3, warmup=1)
        del om, oi
    plain_ms = timed(lambda: fs.scan_buckets_plain(q, rows, pen, nlim, t, L), reps=1, warmup=0)
    q_bf = q.to(torch.bfloat16)
    rows_bf = rows.to(torch.bfloat16)
    step = max(128, (2 << 30) // (2 * qc))

    def matmul():
        for lo in range(0, n, step):
            torch.matmul(q_bf, rows_bf[lo : lo + step].T)

    matmul_ms = timed(matmul, reps=3, warmup=1)
    del rows_bf
    int_mm_ms = None
    if native and q.dtype == rows.dtype:
        q8, rows8 = int8_operands(q, rows)
        step8 = max(128, (2 << 30) // (4 * qc) // 128 * 128)

        def int_mm():
            for lo in range(0, rows8.shape[0], step8):
                torch._int_mm(q8, rows8[lo : lo + step8].T)

        int_mm_ms = timed(int_mm, reps=3, warmup=1)
        del rows8
    bound, by = scan_bound(qc, n, d, nb, row_bytes=rows.element_size(),
                           q_bytes=q.element_size())
    restore_launches(saved)
    return {"variant": fs.scan_variant(q, rows, pen, t, L), "qc": qc, "n": n, "d": d,
            "rows": str(rows.dtype).removeprefix("torch."),
            "queries": str(q.dtype).removeprefix("torch."), "L": L, "T": t,
            "ms": ms, "plain_ms": plain_ms, "matmul_bf16_ms": matmul_ms, "int_mm_ms": int_mm_ms,
            "also_ms": also_ms, "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "key_max": key_max, "ids_equal": ids_equal}


def int8_operands(q: torch.Tensor, rows: torch.Tensor):
    """int8 copies of 8-bit queries and rows for `torch._int_mm`: uint8
    values shifted by 128 (x ^ 0x80 read as int8 is x - 128), rows padded
    with zero rows and both with zero columns to multiples of 8 (its rule
    for the inner and the output width; MS SPACEV's d = 100 becomes 104:
    zero columns add 0 to every product)."""
    n, d = rows.shape
    n8, d8 = -(-n // 8) * 8, -(-d // 8) * 8
    rows8 = torch.zeros((n8, d8), dtype=torch.int8, device=rows.device)
    q8 = torch.zeros((q.shape[0], d8), dtype=torch.int8, device=q.device)
    shift = rows.dtype == torch.uint8
    for lo in range(0, n, 1 << 24):
        part = rows[lo : lo + (1 << 24)]
        rows8[lo : lo + part.shape[0], :d] = (part ^ 128).view(torch.int8) if shift else part
    q8[:, :d] = (q ^ 128).view(torch.int8) if shift else q
    return q8, rows8


def restore_launches(saved: dict) -> None:
    fs.scan_buckets.launches = saved["scan_buckets"]
    fs.scan_buckets.variants = dict(saved["scan_buckets_variants"])
    gather_distances.launches = saved["gather_distances"]


@contextlib.contextmanager
def recorded_hop(width: int, nth: int = 4):
    """A `measure.CallRecorder` in place of the graph search's K2 for the
    block: it keeps the arguments of the `nth` call whose [B, C] ids have
    C == `width` (a full-width hop: the first hops start from the few entry
    points and repeat rows more than a typical one). The table is kept by
    reference."""
    rec = CallRecorder(search_mod.gather_distances,
                       lambda vectors, ids, queries, metric: ids.shape[1] == width, nth, shared=(0,))
    search_mod.gather_distances = rec
    try:
        yield rec
    finally:
        search_mod.gather_distances = rec.fn


def k2_times(args) -> dict | None:
    """K2 (`gather_distances`) alone at recorded arguments, beside its plain
    version and its bound; it must be bit-equal to the plain version at
    every id in [0, N) and give NaN at the others (the hop hands it -1
    where a candidate is not fresh). Not counted on the runner's path. None
    without a recorded call on the card."""
    if args is None or not args[0].is_cuda:
        return None
    saved = launches()
    vectors, ids, queries, metric = args
    ok = (ids >= 0) & (ids < vectors.shape[0])
    got = gather_distances(*args)
    want = gather_distances_plain(vectors, ids.clamp(0, vectors.shape[0] - 1), queries, metric)
    if not (torch.equal(got[ok], want[ok]) and bool(got[~ok].isnan().all())):
        raise RuntimeError("K2 is not bit-equal to its plain version")
    ms = timed(lambda: gather_distances(*args), reps=10, warmup=2)
    plain_ms = timed(lambda: gather_distances_plain(*args), reps=2, warmup=1)
    bound, by = gather_bound(vectors, ids, queries)
    restore_launches(saved)
    return {"B": ids.shape[0], "C": ids.shape[1], "d": vectors.shape[1],
            "table": str(vectors.dtype).removeprefix("torch."),
            "distinct_rows": int(torch.unique(ids).numel()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0}


def sidecar(variant: str, efc: int) -> dict | None:
    """The JAX run's recorded reference C++ baseline for this variant and
    efc (`benchmarks/results_<variant>_efc<efc>.json.refside.json`), read as
    numbers; None where there is none."""
    path = os.path.join(REPO, "benchmarks", f"results_{variant}_efc{efc}.json.refside.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def reduced(n: int, full_n: int, nq: int, full_nq: int, why: str | None, *cuts: str) -> list:
    """What a run cut against the source's configuration: rows, queries and
    the engines in `cuts` (empty strings are dropped); `why` closes a
    non-empty list."""
    out = [] if n == full_n else [f"n={n} of the source's {full_n} rows"]
    if nq != full_nq:
        out.append(f"{nq} queries of the source's {full_nq}")
    out += [c for c in cuts if c]
    if why and out:
        out.append(f"why: {why}")
    return out


def write_results(result: dict, name: str, results_dir: str | None, merge: bool = False) -> str:
    """Write `result` as `<results_dir>/<name>` (default `bench/results/`);
    with `merge`, over the keys of a file already there."""
    out_dir = results_dir or RESULTS
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    if merge and os.path.exists(path):
        with open(path) as f:
            result = {**json.load(f), **result}
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return path
