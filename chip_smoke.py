#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (flatnav_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-2 only (build + kernel checks)

Phases, in order; any failure raises and the script exits nonzero:

  1. environment and build: the card's name and power limit (nvidia-smi),
     torch and CUDA versions, and every kernel under
     flatnav_tpu_torch/csrc built by nvcc (in parallel) with its seconds.
  2. each kernel against its plain PyTorch version, on the card:
     K2 gather_distances bit-equal (torch.equal) at d in {7, 37, 100, 128, 960,
     1536, 3072, 4096, 8192} (from 1536 on, the carry-stack path), L2/IP,
     f32/bf16/f16 tables, ragged B x C; K1 scan_buckets bit-equal on
     uint8/int8 tables against 8-bit or integer-valued bf16 queries and
     within 1e-5 of the key magnitude otherwise (ids equal wherever a
     bucket's best two keys differ by more), at d in {37, 64, 128, 256} on
     bf16 tables, uint8/int8 tables at d in {37, 64, 100, 128, 256} with
     integer-valued and with normal bf16 queries, 8-bit queries of 8-bit
     tables at d in {64, 100, 128, 256}, and bf16 also at d in {25, 50, 100,
     960, 1032, 1536, 3072} as fused_knn hands them over (padded to 32, 56 and
     104), L2/IP, N
     not a multiple of the tile and n_valid < N; each case must take the
     variant the wrapper's rule names: "wgmma_narrow" for bf16 at d <= 32,
     "wgmma" for bf16 at 32 < d <= 384 (d=37 padded to 40, 56, 104),
     "wgmma_wide" at d=960, "wgmma_deep" past d=1024, "wgmma_int8" for
     8-bit queries of 8-bit rows at
     d % 16 == 0, "wgmma_int8_packed" for them at d=100, "wgmma_mixed" for
     bf16 queries of 8-bit rows at d % 4 == 0, "mma" for the rest (8-bit
     rows at d=37). K3 select_k bit-equal (keys by their
     bits, ids) on K3_CASES: k in {1, 7, 8, 10, 32, 50, 64, 1024, K_MAX}, rows
     of 7 to 390,656 columns, B from 1 to 16,384, full / row / implicit ids
     with column windows, keys with +-0, +-inf and NaN of both signs, whole
     rows of +inf, integer keys with thousands of ties, repeated pairs; each
     scan's tile seeded with a running shortlist (`prior=`), the warp-a-row
     shapes (the build's block, the routed scan, a merge), keys that start
     off a 16-byte boundary; both routes must have launched.
  3. the main path at full width, the README configuration: clustered data
     (seed 0x5EED), N=100,000, d=128 float32, L2, M=32, ef_construction=100,
     4,096 queries, K=10: create -> add -> search(ef_search=192) ->
     search_exact(rerank=0 / 32 / 32 without exact rerank) -> save ->
     load_index -> search (must be identical). Kernel launch counters are
     zeroed just before and read just after; recall@10 of every engine is
     measured against the port's brute_force_knn, run inside that window.
     K3 must have launched in brute_force_knn, in the build and in
     search_exact (counts by step and by route printed). Each kernel is
     then held against its plain version on the arguments the path gave it
     (a search hop and a build wave of B=8192, C=1024 for K2, the first
     scan of search_exact for K1, its first phase-B selection (block route)
     and a build selection (warp route) for K3); K2 is timed at both, and
     K3's warp route at that build selection (its own entry in the kernels
     line, "select_k warp", with the warp route's launches). The hop's
     kernels (csrc/beam_hop.cu) must have run three launches a hop in the
     build and in both searches (BeamHop.launches zeroed before each, read
     after). Then, on the main path's graph, each is held against its
     PyTorch stage at every hop of a search at the graph cells' shapes
     (1,000 queries at ef 512 / E 64 and ef 192 / E 16; ef 192 / E 64
     compacted to 512; a build wave of 8,192 rows at ef 100 / E 16):
     selected ids, expanded marks, the history, fresh flags, the beams (by
     their bits), the counters and the end flag equal; and timed beside the
     chain (bench/kernel_ab.py's hop cases), each stage beside its own
     bound (the kernels line's "beam_hop" entry).
  4. the scan at SIFT1M scale: search_exact(rerank=32) and fused_knn over a
     1M x 128 float32 clustered table with B=4096, with recall and K1 time;
     K3 at phase B of that scan (keys [4096, 62592] -> 32, ids read),
     bit-equal and timed beside its plain version, torch.topk of the float
     keys and its bound; then the stage profiler's stages (bench/profile_fused_stages.py:
     matmul, phaseA = K1', phaseAB, norerank, full, gather) on the same
     table, with K1's launches counted over them.
  5. reorder / import, on the main path's index: search(ef_search=192) is
     recorded, then reorder(["gorder"]) and reorder(["rcm"]) (timed; the
     native library or the Python path, as printed). The relabelled graph
     must be the old one under one permutation of the node ids, recall@10
     must stay within 0.005, and the share of result slots with the same
     label is printed and held to the limit below (the entry candidates of
     a search are rows at a fixed stride of node ids, so a relabel starts
     some queries elsewhere). The reordered search must launch K2. The
     links are written as a MatrixMarket file and imported into a fresh
     index (allocate_nodes + build_graph_links): links equal, search
     identical; save / load_index round trip identical.
  6. the product-quantized index, the configuration of
     benchmarks/run_bigann_10m.py (m_pq=16, nbits=8, 25 k-means iterations,
     rerank=64): (a) train on the main path's 100k rows, PQIndex of 100k,
     M=32, ef_construction=100, search(K=10, ef_search=192) over the 4,096
     queries, recall@10 against brute_force_knn and against the exact ADC
     ranking, save / load identical; (b) pq_scan_knn over phase 4's
     1M x 128 table with B=4096: raw-vector rerank, exact-ADC rerank,
     the 4-bit point (m_pq=16, nbits=4, packed two codes a byte) and
     lane_packed equal to unpacked; the scan's stages and its two key
     routes are timed. Peak device memory of the raw and the PQ build is
     printed.
  7. the benchmark harness (bench/run_benchmark.py) on the main path's data,
     written as an .npy triplet and as .fbin with a big-ann ground-truth
     file: `main([...])` for flatnav (ef_search 64 128 192 256, batch 2048),
     flatnav-fused, flatnav-fusednr, flatnav-exact (from the .fbin) and
     flatnav-pq-scan (with --memory-log). Every default metric must be
     present and finite, recall exact = 1.0, fused >= 0.98, graph >= 0.90 at
     ef=192 and not decreasing in ef, the latency percentiles ordered,
     distance_computations > 0, and K1 and K2 must have been launched. Then
     the two CLIs: tools.construct (`main`, in this process) builds and saves
     the 100k index, tools.query sweeps it as a `python -m` subprocess, then
     in this process with --reorder.
  8. the headline benchmark (bench/headline.py) at its defaults, its `main`
     in this process: the last line is parsed and printed whole; its baseline must
     come from baseline_ref.json (the workload key matches), every engine's
     recall is held to the limits above, the winner's to 0.95, mfu <= 1, and
     its own K1 and K2 launch counts must be above zero. The graph point it
     chose is then re-run on the index it saved at E=64, in full, with
     m_search=16 and with compact_width=512 (recall and qps of each printed);
     K2 is held against its plain version at a hop of C=512 compacted ids.
  9. the routed scan (bench/profile_routed_scan.py at its defaults: 100k x
     128, 1,024 queries, block 512): the full union must equal
     brute_force_knn, the end-to-end recalls must lie within 0.02 of those
     recorded in benchmarks/results_routed_scan.json, and routed_knn's time
     is printed beside fast_knn's (CUDA events).
  10. parallel/ on the main path's (reordered) graph, data and queries, run
     after phase 7: a (1, 1) NCCL mesh (a process group of this process
     alone) runs every sharded function
     (sharded_search E=16, data_parallel_search, sharded_exact_search exact
     and fused, sharded_pq_scan with phase 6's quantizer and raw rerank, the
     mesh build in both layouts over the first 10,000 rows); four gloo ranks
     on the one card run (1, 4) model-sharded search, exact, fused, PQ and
     build, and (2, 2) data-parallel search and replicated build. Each
     result must equal the single-device port's on the same inputs (the
     two-phase scans: the same engine shard by shard), and each rank must
     have launched its kernels (per-rank counts printed and in the kernels
     line). K1 on a shard's rows and K2 on a shard's table are held against
     their plain versions. The two gloo meshes and the dry run
     (parallel.dryrun_multichip's rank program) share one start of the four
     ranks (parallel.dryrun.run_meshes).
  11. the north-star runners (bench/northstar.py, bench/bigann_10m.py,
     bench/bigann_100m.py) through `main(argv)` at a small scale: angular
     (d=100, IP) and gist (d=960) at 100k rows with one graph point, the
     BigANN-class 10M runner at 100k uint8 rows, the 100M runner at 1M rows
     with its scan engines only; 2,048 queries each. Counts zeroed before each
     run and read after it; recalls held to the floors above phase_northstar;
     K1 must take "wgmma" at d=100, "wgmma_wide" at d=960 and "wgmma_int8"
     on both uint8 runs, and never "mma"; each timed and held against its
     plain version at its run's shapes, beside a bf16 torch.matmul (and
     torch._int_mm on the uint8 tables); K2 at the d=100 / d=960 hops.
  12. the reference's last three datasets at their shapes, on synthetic data
     from a seed (NEW_SHAPES): fused_knn (K=10, rerank 32, 4,096 queries)
     over an int8 10M x 100 L2 table (MS SPACEV's 10M slice), 1,183,514
     unit rows of d=25 and d=50 under IP (GloVe-25, GloVe-50) and a uint8
     10M x 128 L2 table searched with float32 queries (table rows plus
     normal noise of FLOATQ_NOISE; a BigANN-class table with float
     queries). Counts zeroed before each call and read after it: K1 must
     take "wgmma_int8_packed", "wgmma_narrow", "wgmma" and "wgmma_mixed"
     alone, never "mma"; recall@10 against brute_force_knn on the first 256
     queries is held to NEW_FLOOR; K1 alone at each shape is held against
     its plain version (bit-equal on int8; within 1e-5 of the largest key
     with ids equal on 99% of buckets otherwise) and timed beside its
     bound, a bf16 torch.matmul, (int8) torch._int_mm and ("wgmma_mixed")
     the "mma" kernel it replaced.
  13. OpenAI's embedding widths on synthetic unit rows (the published sets
     are not in the repo): the Index lifecycle at d=1536, angular, cut to
     OPENAI_ROWS rows (full width), create -> add -> search over
     bench.headline.EF_SWEEP up to the first ef whose recall@10 reaches 0.90
     (printed; none: the phase fails) -> search_exact exact (1.0) and
     rerank=32 (>= 0.98) -> save -> load_index (identical), K1 on
     "wgmma_deep" alone and K2 (the carry-stack path) in build and search,
     each held against its plain version at a recorded call and K2 timed at
     a search hop; then fused_knn over 1M unit rows of d=1536 and d=3072
     (4,096 queries, "wgmma_deep" alone, recall@10 >= 0.98 on the first 256
     against brute_force_knn), `_northstar.k1_times` at both, and K2 timed
     at a hop of random ids over the 1M x 3072 table.

The line before the last is one JSON object with each kernel's launches,
error against its plain version, times and bound (a kernel with several
variants or routes has an entry for each that the run times: K1's
"wgmma_wide", "wgmma_deep", "wgmma_int8", "wgmma_int8_packed",
"wgmma_narrow" and "wgmma_mixed", K2's "carry stack", K3's "warp"; the
hop's kernels as "beam_hop"); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def recall(found, truth) -> float:
    k = truth.shape[1]
    return float(sum(len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found, truth))) / (
        truth.shape[0] * k
    )


def phase_build():
    import torch

    from flatnav_tpu_torch import _build
    from flatnav_tpu_torch.bench.measure import card

    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    print(f"nvcc build: {time.perf_counter() - t0:.1f} s for {_build.sources()}")
    for name, (sec, report) in sorted(_build.reports.items()):
        usage = [ln.strip() for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: {sec:.1f} s; " + " | ".join(usage[:6]))


def _bucket_gap(q, rows, pen, nlim, t, L):
    """[qc, nb] gap between the best and second-best key of each bucket, in
    f32 from the same bf16 inputs (one row tile at a time)."""
    import torch

    qc, s = q.shape[0], t // L
    qf = q.float()
    gaps = []
    for r0 in range(0, rows.shape[0], t):
        tile = rows[r0 : r0 + t].float()
        pen_t = pen[r0 : r0 + t]
        if tile.shape[0] < t:
            tile = torch.nn.functional.pad(tile, (0, 0, 0, t - tile.shape[0]))
            pen_t = torch.nn.functional.pad(pen_t, (0, t - pen_t.shape[0]))
        key = pen_t[None, :] - 2.0 * (qf @ tile.T)
        key[:, max(0, nlim - r0):] = float("inf")
        top2 = key.view(qc, L, s).topk(2, dim=1, largest=False).values
        gaps.append(top2[:, 1] - top2[:, 0])
    return torch.cat(gaps, dim=1)


def k1_against_plain(q, rows, pen, nlim, t, L, tag) -> float:
    """Run K1 and its plain version on the same inputs; 8-bit tables against
    8-bit or integer-valued bf16 queries must be bit-equal (every partial
    sum is an integer below 2^24), other minima within 1e-5 of the largest
    key magnitude (the sums run in another order) with ids equal wherever a
    bucket's best two keys differ by more than twice that. Returns the max
    abs error."""
    import torch

    from flatnav_tpu_torch.ops.fused_scan import exact_keys, scan_buckets, scan_buckets_plain

    kmin, kid = scan_buckets(q, rows, pen, nlim, t, L)
    pmin, pid = scan_buckets_plain(q, rows, pen, nlim, t, L)
    torch.cuda.synchronize()
    fin = torch.isfinite(pmin)
    check(torch.equal(fin, torch.isfinite(kmin)), f"K1 inf mask {tag}")
    err = float((kmin[fin] - pmin[fin]).abs().max()) if bool(fin.any()) else 0.0
    if exact_keys(q, rows):
        check(torch.equal(kmin, pmin) and torch.equal(kid, pid), f"K1 bit-equal {tag}")
        return err
    tol = 1e-5 * float(pmin[fin].abs().max())
    check(err <= tol, f"K1 minima within {tol:g} {tag}: {err:g}")
    sure = _bucket_gap(q, rows, pen, nlim, t, L) > 2 * tol
    check(torch.equal(kid[sure], pid[sure]), f"K1 ids {tag}")
    return err


def k2_against_plain(vectors, ids, queries, metric, tag) -> float:
    """K2 must be bit-equal to its plain version; returns the max abs error."""
    import torch

    from flatnav_tpu_torch.ops.gather_distance import (
        gather_distances,
        gather_distances_plain,
    )

    got = gather_distances(vectors, ids, queries, metric)
    want = gather_distances_plain(vectors, ids, queries, metric)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K2 bit-equal {tag}")
    return float((got - want).abs().max())


def k3_against_plain(keys, k, ids=None, id_base=0, cols=None, tag="", prior=None) -> float:
    """K3 must be bit-equal to its plain version: ids equal and keys equal
    in their bits (so NaN keys too). Returns the max abs error over the
    finite keys (0 when bit-equal)."""
    import torch

    from flatnav_tpu_torch.ops.select_k import select_k, select_k_plain

    before = select_k.launches
    got = select_k(keys, k, ids=ids, id_base=id_base, cols=cols, prior=prior)
    want = select_k_plain(keys, k, ids=ids, id_base=id_base, cols=cols, prior=prior)
    torch.cuda.synchronize()
    check(select_k.launches > before, f"K3 launched {tag}")
    check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
          and torch.equal(got[1], want[1]), f"K3 bit-equal {tag}")
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max()) if bool(fin.any()) else 0.0


#: K3's cases in phase 2: (B, W, k, ids, keys[, extra]). The shapes of its
#: callers (phase B at 1M x 128 and at 100M uint8, a fast_knn, a
#: brute_force_knn and a PQ tile with their column windows, each also seeded
#: with a running shortlist as `_merge_tile` gives it ("prior"), the build's
#: intra-wave block, the routed scan's rows to their cells and a merge of
#: two r-wide lists (the warp route), a PQ tile at the widest rerank), one
#: long row, the largest k, rows of special keys, and keys that start off a
#: 16-byte boundary ("offset"; W % 4 != 0 puts every later row off one too).
K3_CASES = [
    (4096, 62_592, 32, "full", "normal"),
    (512, 390_656, 32, "full", "ties"),
    (1, 390_656, 1024, "implicit", "normal"),
    (4096, 131_072, 32, "implicit", "normal"),
    (4096, 131_072, 32, "implicit", "normal", "prior"),
    (4096, 65_536, 10, "implicit", "ties"),
    (4096, 65_536, 10, "implicit", "ties", "prior"),
    (4096, 32_768, 64, "implicit", "normal", "prior"),
    (8192, 8192, 64, "broadcast", "masked"),
    (16_384, 196, 8, "broadcast", "normal"),
    (4096, 64, 32, "full", "normal"),
    (64, 32_768, 1024, "implicit", "ties"),
    (16, 100_000, "K_MAX", "implicit", "normal"),
    (16, 100_000, "K_MAX", "implicit", "normal", "prior"),
    (4096, 1000, 64, "full", "inf"),
    (1, 5000, 10, "full", "nan"),
    (100, 3000, 50, "full", "dup"),
    (37, 7, 1, "broadcast", "special"),
    (1, 7, 7, "implicit", "special"),
    (512, 131_071, 32, "full", "normal", "offset"),
    (333, 8191, 64, "broadcast", "ties", "offset"),
]


def k3_case(b, w, ids_kind, keys_kind, seed):
    """Keys and ids of one K3 case, made on the card from `seed`:
    normal keys with +-0, +-inf and NaN of both signs at 1% of the places;
    integer-valued keys in [0, 64) (8-bit tables: thousands of exact ties);
    the build's masked block (key +inf unless column < row); whole rows of
    +inf; NaN of both signs; integer keys in [0, 4) with ids in [0, 100)
    (repeated pairs); only special values. -> (keys, ids or None, id_base,
    cols)"""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0],
                           device=dev)
    special = torch.cat([special, -special[4:5]])  # a NaN with the sign bit set
    if keys_kind in ("normal", "masked"):
        keys = torch.randn((b, w), device=dev, generator=g)
        if keys_kind == "masked":
            col = torch.arange(w, device=dev)
            keys = torch.where(col[None, :] < torch.arange(b, device=dev)[:, None] % w, keys,
                               float("inf"))
        else:
            at = torch.randint(0, b * w, (max(1, b * w // 100),), device=dev, generator=g)
            keys.view(-1)[at] = special[torch.randint(0, len(special), at.shape, device=dev,
                                                      generator=g)]
    elif keys_kind == "ties":
        keys = torch.randint(0, 64, (b, w), device=dev, generator=g).float()
    elif keys_kind == "dup":
        keys = torch.randint(0, 4, (b, w), device=dev, generator=g).float()
    elif keys_kind == "inf":
        keys = torch.full((b, w), float("inf"), device=dev)
    elif keys_kind == "nan":
        keys = torch.full((b, w), float("nan"), device=dev)
        keys[:, ::2] = -keys[:, ::2]
    else:
        keys = special[torch.randint(0, len(special), (b, w), device=dev, generator=g)]
    ids, id_base, cols = None, 0, None
    if ids_kind == "full":
        hi = 100 if keys_kind == "dup" else (1 << 31) - 1
        ids = torch.randint(0, hi, (b, w), device=dev, generator=g, dtype=torch.int32)
    elif ids_kind == "broadcast":
        ids = torch.randperm(w, device=dev, generator=g).to(torch.int32)[None, :]
    else:
        id_base = 1_000_000
        cols = (w // 100, w - w // 7) if w > 100 else None
    return keys, ids, id_base, cols


def k3_prior(keys, k, seed):
    """A running shortlist [B, k] for a seeded case: the sorted smallest keys
    of an earlier tile (normal keys shifted down, ids below the tile's), its
    second half the (+inf, id 0) padding a scan starts from."""
    import torch

    g = torch.Generator(device=keys.device).manual_seed(seed)
    b = keys.shape[0]
    d = torch.sort(torch.randn((b, k), device=keys.device, generator=g) - 2.5, dim=1).values
    i = torch.randint(0, 1_000_000, (b, k), device=keys.device, generator=g, dtype=torch.int32)
    d[:, k // 2 :], i[:, k // 2 :] = float("inf"), 0
    return d.contiguous(), i.contiguous()


def at_offset(x, off):
    """x copied into a flat buffer `off` elements past a 16-byte boundary"""
    import torch

    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    y = flat[off : off + x.numel()].view(x.shape)
    y.copy_(x)
    return y


def phase_k3():
    """K3 against its plain version on every case of K3_CASES; both routes
    must launch. -> max abs error"""
    import torch

    from flatnav_tpu_torch.ops.select_k import K_MAX, select_k

    err = 0.0
    routes = dict(select_k.routes)
    for i, (b, w, k, ids_kind, keys_kind, *extra) in enumerate(K3_CASES):
        k = K_MAX if k == "K_MAX" else k
        keys, ids, id_base, cols = k3_case(b, w, ids_kind, keys_kind, seed=i)
        prior = k3_prior(keys, k, seed=100 + i) if extra == ["prior"] else None
        if extra == ["offset"]:
            keys = at_offset(keys, 1 + i % 3)
            check(keys.data_ptr() % 16 != 0, "K3 keys off a 16-byte boundary")
        err = max(err, k3_against_plain(keys, k, ids, id_base, cols,
                                         f"B={b} W={w} k={k} {ids_kind} ids, {keys_kind} keys"
                                         f"{' ' + extra[0] if extra else ''}", prior=prior))
        del keys, ids, prior
    torch.cuda.empty_cache()
    routes = {r: select_k.routes[r] - routes[r] for r in routes}
    check(all(v > 0 for v in routes.values()), "K3's block and warp routes both launched")
    print(f"K3 select_k: bit-equal to the plain version on {len(K3_CASES)} cases "
          f"(k up to K_MAX={K_MAX}, W from 7 to 390,656, B from 1 to 16,384, seeded and "
          f"unaligned cases included); launches by route {routes}")
    return err


#: K2's widths in phase 2: angular's d=100, gist's d=960, OpenAI's 1536 and
#: 3072, and the carry-stack path's 4096 and 8192 among them
K2_WIDTHS = (7, 37, 100, 128, 960, 1536, 3072, 4096, 8192)


def phase_kernels(rng):
    """-> (K2 max abs error, K1 max abs error)"""
    import torch

    from flatnav_tpu_torch.ops import MetricType
    from flatnav_tpu_torch.ops.distances import squared_norms
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets, scan_operands

    dev = torch.device("cuda")
    k2_err = 0.0
    n, b, c = 5000, 37, 129  # ragged B x C
    for d in K2_WIDTHS:
        # one table, id block and query block a width (numpy's normal draws
        # of the widest tables took seconds), the table cast to each type
        table = torch.from_numpy(rng.standard_normal((n, d), dtype="float32")).to(dev)
        ids = torch.from_numpy(rng.integers(0, n, (b, c)).astype("int32")).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, d), dtype="float32")).to(dev)
        for metric in (MetricType.L2, MetricType.IP):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                k2_err = max(k2_err, k2_against_plain(
                    table.to(dtype), ids, q, metric, f"d={d} {metric.value} {dtype}"))
    print(f"K2 gather_distances: bit-equal to the plain version on {6 * len(K2_WIDTHS)} cases")

    k1_err = 0.0
    t, L = 2048, 16
    # (d, row type, queries, the variant the wrapper must pick); queries of
    # an 8-bit table are of its type ("8bit"), integer-valued bf16 ("int")
    # or normal bf16 ("normal"); bf16 d=37 reaches the kernel padded to 40
    bf16, u8, i8 = torch.bfloat16, torch.uint8, torch.int8
    cases = [(d, bf16, "normal", "wgmma") for d in (37, 64, 128, 256)]
    # bf16 queries of an 8-bit table (the TPU kernel's own form for it):
    # "wgmma_mixed" where d % 4 == 0, by TMA or (d=100) the packed copies
    cases += [(d, dtype, qk, "mma" if d % 4 else "wgmma_mixed")
              for d in (37, 64, 100, 128, 256) for dtype in (u8, i8) for qk in ("int", "normal")]
    # 8-bit queries of an 8-bit table (the BigANN runners', MS SPACEV's
    # d=100), and the widths of the north star and of GloVe as fused_knn
    # hands them over: 25, 50 and angular's 100 padded to 32, 56 and 104,
    # gist's d=960
    cases += [(d, dtype, "8bit", "wgmma_int8" if d % 16 == 0 else "wgmma_int8_packed")
              for d in (64, 100, 128, 256) for dtype in (u8, i8)]
    cases += [(25, bf16, "normal", "wgmma_narrow"), (50, bf16, "normal", "wgmma"),
              (100, bf16, "normal", "wgmma"), (960, bf16, "normal", "wgmma_wide")]
    # bf16 past d = 1024: OpenAI's 1536 and 3072, and the first width past
    # "wgmma_wide"'s
    cases += [(d, bf16, "normal", "wgmma_deep") for d in (1032, 1536, 3072)]
    for d, dtype, qk, want in cases:
        for metric in (MetricType.L2, MetricType.IP):
            n, nlim, qc = 10000, 9000, 100  # n not a multiple of t
            if dtype == torch.bfloat16:
                rows = torch.from_numpy(rng.standard_normal((n, d), dtype="float32")).to(dev, dtype)
                q = torch.from_numpy(rng.standard_normal((qc, d), dtype="float32")).to(dev, dtype)
            else:
                lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
                rows = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype("int16")).to(dev, dtype)
                if qk == "normal":
                    q = (lo + hi) / 2 + 50 * rng.standard_normal((qc, d), dtype="float32")
                    q = torch.from_numpy(q).to(dev, torch.bfloat16)
                else:
                    q = torch.from_numpy(rng.integers(lo, hi, (qc, d)).astype("int16")).to(dev)
                    q = q.to(dtype if qk == "8bit" else torch.bfloat16)
            pen = (squared_norms(rows) if metric == MetricType.L2
                   else torch.zeros(n, device=dev))
            rows, q = scan_operands(rows, q) if dtype == torch.bfloat16 else (rows, q)
            before = scan_buckets.variants[want]
            k1_err = max(k1_err, k1_against_plain(
                q, rows, pen, nlim, t, L, f"d={d} {metric.value} {dtype} q {q.dtype}"))
            check(scan_buckets.variants[want] == before + 1, f"K1 d={d} {dtype} took {want}")
    print(f"K1 scan_buckets: 8-bit rows against 8-bit or integer-valued queries bit-equal, "
          f"the rest max abs err {k1_err:g}, on {2 * len(cases)} cases; launches by variant "
          f"{scan_buckets.variants}")
    return k2_err, k1_err


def phase_main_path():
    import numpy as np
    import torch

    import flatnav_tpu_torch
    from flatnav_tpu_torch.bench.measure import CallRecorder
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.index import build as build_mod
    from flatnav_tpu_torch.index import search as search_mod
    from flatnav_tpu_torch.ops import brute_force_knn
    from flatnav_tpu_torch.ops import fused_scan as fused_mod
    from flatnav_tpu_torch.ops.beam_hop import BeamHop
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances
    from flatnav_tpu_torch.ops.select_k import select_k
    from flatnav_tpu_torch.utils.profiling import device_memory_stats

    n, d, m, efc, nq, k, ef = 100_000, 128, 32, 100, 4096, 10, 192
    data, queries = clustered(n, d, nq, seed=0x5EED)
    # keep the 88th build-wave call (B=8192, C=1024; about half of the
    # build's, in its 7th wave: the first waves score a nearly empty graph),
    # the 4th full-width hop of the graph search (its first hops start from
    # the few entry points and repeat rows far more than a typical hop) and
    # the first K1 call of search_exact
    wave_rec = CallRecorder(gather_distances, lambda v, ids, q, mt: tuple(ids.shape) == (8192, 1024),
                            nth=88)
    hop_rec = CallRecorder(wave_rec, lambda v, ids, q, mt: ids.shape[1] == 16 * m, nth=4)
    scan_rec = CallRecorder(scan_buckets)
    # phase B's first selection (K3) of search_exact(rerank=32)
    phase_b_rec = CallRecorder(fused_mod.smallest_k)
    # a build wave's intra-wave selection (K3's warp route), its 10th
    build_sel_rec = CallRecorder(build_mod.smallest_k, nth=10)
    search_mod.gather_distances = hop_rec
    fused_mod.scan_buckets = scan_rec
    fused_mod.smallest_k = phase_b_rec
    build_mod.smallest_k = build_sel_rec
    out = {}
    k3 = {}  # K3 launches by step of the path
    k3_routes = {}  # ... and by route

    def routes_since(before):
        return {r: select_k.routes[r] - before[r] for r in before}
    try:
        gather_distances.launches = 0
        scan_buckets.launches = 0
        scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
        select_k.launches = 0
        select_k.routes = dict.fromkeys(select_k.routes, 0)
        # the ground truth of every recall below: brute_force_knn (K3)
        _, gt = brute_force_knn(torch.from_numpy(data).cuda(), torch.from_numpy(queries).cuda(), k)
        gt = gt.cpu().numpy()
        k3["brute_force_knn"] = select_k.launches
        k3_routes["brute_force_knn"] = routes_since(dict.fromkeys(select_k.routes, 0))
        routes_before = dict(select_k.routes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        BeamHop.launches = 0
        index = flatnav_tpu_torch.index.create(
            "l2", dim=d, dataset_size=n, max_edges_per_node=m, device="cuda"
        )
        index.add(data, ef_construction=efc)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        hop_launches = {"build": BeamHop.launches}  # the hop's kernels by step
        k3["build"] = select_k.launches - k3["brute_force_knn"]
        k3_routes["build"] = routes_since(routes_before)
        out["build_peak"] = device_memory_stats()["peak_bytes_in_use"]
        hop_rec.reset()  # keep a query hop, not a build hop

        def run(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dist, lab = fn()
            sec = time.perf_counter() - t
            check(dist.shape == (nq, k) and np.isfinite(dist).all(), f"{name} output")
            out[name] = {"recall": recall(lab, gt), "qps": nq / sec, "s": sec}
            return dist, lab

        BeamHop.launches = 0
        d1, l1 = run("graph", lambda: index.search(queries, K=k, ef_search=ef))
        hop_launches["search"] = BeamHop.launches
        before, routes_before = select_k.launches, dict(select_k.routes)
        run("exact", lambda: index.search_exact(queries, K=k))
        run("fused", lambda: index.search_exact(queries, K=k, rerank=32))
        run("fusednr", lambda: index.search_exact(queries, K=k, rerank=32, exact_rerank=False))
        k3["search_exact"] = select_k.launches - before
        k3_routes["search_exact"] = routes_since(routes_before)
        with tempfile.TemporaryDirectory(dir=REPO) as tmp:
            path = os.path.join(tmp, "smoke_index.npz")
            index.save(path)
            index2 = flatnav_tpu_torch.index.load_index(path, device="cuda")
        BeamHop.launches = 0
        d2, l2 = index2.search(queries, K=k, ef_search=ef)
        torch.cuda.synchronize()
        hop_launches["reloaded search"] = BeamHop.launches
        launches = {"gather_distances": gather_distances.launches,
                    "beam_hop": sum(hop_launches.values()), "beam_hop by step": hop_launches,
                    "scan_buckets": scan_buckets.launches,
                    "scan_buckets variants": dict(scan_buckets.variants),
                    "select_k": select_k.launches, "select_k by step": k3,
                    "select_k by route": dict(select_k.routes),
                    "select_k by step and route": k3_routes}
    finally:
        search_mod.gather_distances = gather_distances
        fused_mod.scan_buckets = scan_buckets
        fused_mod.smallest_k = phase_b_rec.fn
        build_mod.smallest_k = build_sel_rec.fn
    check(np.array_equal(l1, l2) and np.array_equal(d1, d2), "reloaded search identical")
    print(f"main path: N={n} d={d} M={m} ef_construction={efc} build {out['build_s']:.2f} s, "
          f"peak device memory {out['build_peak'] / 1e6:.1f} MB, "
          f"index_memory_bytes {index.index_memory_bytes() / 1e6:.1f} MB")
    for name in ("graph", "exact", "fused", "fusednr"):
        r = out[name]
        print(f"  {name}: recall@10 {r['recall']:.4f}  qps {r['qps']:.1f}  ({r['s']:.3f} s)")
    print(f"  launches on the main path: {launches}")
    check(launches["gather_distances"] > 0 and launches["scan_buckets"] > 0, "kernel launches")
    check(all(v > 0 and v % 3 == 0 for v in hop_launches.values()),
          f"the hop's three kernels ran every hop of the build and the searches: {hop_launches}")
    check(all(v > 0 for v in k3.values()),
          "K3 launched in brute_force_knn, the build and search_exact")
    check(launches["scan_buckets variants"]["wgmma"] == launches["scan_buckets"],
          "the main path's K1 takes the wgmma variant alone")
    check(out["exact"]["recall"] == 1.0, "exact recall == 1.0")
    check(out["fused"]["recall"] >= 0.98, "fused recall >= 0.98")
    check(out["graph"]["recall"] >= 0.90, "graph recall >= 0.90")
    check(hop_rec.args is not None and wave_rec.args is not None and scan_rec.args is not None
          and phase_b_rec.args is not None and build_sel_rec.args is not None,
          "a search hop, a build wave, a scan call and two K3 selections were recorded")
    check(all(v > 0 for v in launches["select_k by route"].values()),
          "the main path launched both of K3's routes")
    # each kernel against its plain version at the shapes the path gave it
    k2_err = k2_against_plain(*hop_rec.args, "main-path hop")
    k2_err = max(k2_err, k2_against_plain(*wave_rec.args, "main-path build wave"))
    q_bf, rows, pen, nlim, t, L = scan_rec.args
    k1_err = k1_against_plain(*scan_rec.args, "main-path scan")
    print(f"  at the main path's shapes: K2 B x C = {tuple(hop_rec.args[1].shape)} and "
          f"{tuple(wave_rec.args[1].shape)} bit-equal; "
          f"K1 q {tuple(q_bf.shape)} rows {tuple(rows.shape)} {rows.dtype} T={t} L={L} "
          f"max abs err {k1_err:g}")
    bmin, bids, r = phase_b_rec.args
    k3_err = k3_against_plain(bmin, r, ids=bids, tag="main-path phase B")
    intra, lane_ids, c2 = build_sel_rec.args
    k3_err = max(k3_err, k3_against_plain(intra, c2, ids=lane_ids, tag="main-path build selection"))
    print(f"  K3 at the main path's phase B: keys {tuple(bmin.shape)} -> {r}, ids read, bit-equal; "
          f"at a build selection: keys {tuple(intra.shape)} -> {c2}, one id row, bit-equal")
    print(f"  K3 launches by step and route: {k3_routes}")
    path = {"index": index, "data": data, "queries": queries, "gt": gt, "labels": l1,
            "dists": d1, "recall": out["graph"]["recall"], "k": k, "ef": ef,
            "build_peak": out["build_peak"]}
    return launches, hop_rec.args, wave_rec.args, build_sel_rec.args, k1_err, k2_err, k3_err, path


def k2_timing(call, what):
    """K2's time at a recorded call, beside its plain version and its bound:
    the distinct rows it gathers, its ids, queries and output, each moved
    once. Also prints the gathered-bytes rate, B*C*d*size over the time."""
    import torch

    from flatnav_tpu_torch.bench.measure import gather_bound, timed
    from flatnav_tpu_torch.ops.gather_distance import gather_distances, gather_distances_plain

    vectors, ids, queries, metric = call
    b, c = ids.shape
    d = vectors.shape[1]
    ms = timed(lambda: gather_distances(vectors, ids, queries, metric))
    plain_ms = timed(lambda: gather_distances_plain(vectors, ids, queries, metric), reps=3, warmup=1)
    uniq = int(torch.unique(ids).numel())
    bound, by = gather_bound(vectors, ids, queries)
    gathered = b * c * d * vectors.element_size()
    print(f"K2 at a {what} B={b} C={c} d={d} ({uniq} distinct rows): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, distinct-row bound {bound:.4f} ms ({by}); "
          f"gathered {gathered / 1e6:.1f} MB at {gathered / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def phase_beam_hop(path):
    """The hop's kernels at the graph cells' shapes, on the main path's
    graph (M=32): the sift1m.graph cell's hop (1,000 queries, ef 512, E 64),
    the gist1m.graph cell's (ef 192, E 16), the headline's compacted hop
    (ef 192, E 64, compact width 512) and a build wave's (8,192 of the
    table's rows as queries, ef 100, E 16), each held against the chain at
    every hop (bench.kernel_ab.hop_lockstep); then its hop cases time
    the kernels beside the chain, each stage beside its own bound. -> {"hops
    checked", "cases"}."""
    import torch

    from flatnav_tpu_torch.bench.kernel_ab import hop_cases, hop_lockstep
    from flatnav_tpu_torch.index.search import table_blocks
    from flatnav_tpu_torch.ops.distances import MetricType

    g = path["index"].graph
    q = torch.from_numpy(path["queries"][:1000]).cuda()
    rows = torch.from_numpy(path["data"][:8192]).cuda()
    checked = {}
    for tag, queries, ef, e_f, cw in (("sift", q, 512, 64, 0), ("gist", q, 192, 16, 0),
                                      ("compacted", q, 192, 64, 512), ("wave", rows, 100, 16, 0)):
        score, entry = table_blocks(g.vectors, queries, MetricType.L2)
        checked[tag], hop = hop_lockstep(g.links, score, entry, g.num_nodes, queries.shape[0],
                                         ef=ef, e_f=e_f, cw=cw)
        check(hop.workspace is None, f"hop {tag}: the rows fit shared memory")
        del hop
        print(f"beam_hop {tag}: B={queries.shape[0]} ef={ef} E={e_f} compact width {cw}: the "
              f"kernels equal the chain at each of {checked[tag]} hops")
    del q, rows
    torch.cuda.empty_cache()
    return {"hops checked": checked, "cases": hop_cases(5, ["sift", "gist", "wave"])}


def phase_scan_1m():
    import numpy as np
    import torch

    import flatnav_tpu_torch
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.index.graph import graph_from_numpy
    from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fused_knn
    from flatnav_tpu_torch.bench import profile_fused_stages as pfs
    from flatnav_tpu_torch.bench.measure import card, scan_bound, timed
    from flatnav_tpu_torch.ops.fused_scan import (
        _SUMMARY_BYTES, _QB, _TILE, _pick_shapes, scan_buckets, scan_buckets_plain, scan_variant,
    )
    from flatnav_tpu_torch.ops.distances import squared_norms

    n, d, b, k = 1_000_000, 128, 4096, 10
    t0 = time.perf_counter()
    data, queries = clustered(n, d, b, seed=0x5EED)
    print(f"1M scan: data made in {time.perf_counter() - t0:.1f} s")
    ds = torch.from_numpy(data).cuda()
    q = torch.from_numpy(queries).cuda()
    _, gt = brute_force_knn(ds, q, k)
    gt = gt.cpu().numpy()

    g = graph_from_numpy(data, np.arange(n, dtype=np.int32)[:, None], device="cuda")
    index = flatnav_tpu_torch.index.Index(
        MetricType.L2, d, n, 1, _graph=g, device="cuda"
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lab = index.search_exact(queries, K=k, rerank=32)
    sec = time.perf_counter() - t0
    r_api = recall(lab, gt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, fi = fused_knn(ds, q, k, rerank=32)
    torch.cuda.synchronize()
    sec_f = time.perf_counter() - t0
    r_f = recall(fi.cpu().numpy(), gt)
    print(f"1M scan: search_exact(rerank=32) recall@10 {r_api:.4f} ({sec:.3f} s, "
          f"{b / sec:.1f} qps); fused_knn B={b} recall@10 {r_f:.4f} ({sec_f:.3f} s)")
    check(r_api >= 0.98 and r_f >= 0.98, "1M fused recall >= 0.98")

    # K1 alone at the shape fused_knn gives it here
    L, t, _, qc = _pick_shapes(n, b, d, 2, _TILE, _QB, None, _SUMMARY_BYTES)
    check(qc >= b, "one query chunk at B=4096")
    ds_bf, q_bf = ds.to(torch.bfloat16), q.to(torch.bfloat16)
    pen = squared_norms(ds_bf)
    check(scan_variant(q_bf, ds_bf, pen, t, L) == "wgmma", "the 1M scan takes the wgmma variant")
    err = k1_against_plain(q_bf, ds_bf, pen, n, t, L, "1M")
    print(f"K1 at 1M x {d}, B={b}, L={L}, T={t}: max abs err {err:g}")
    ms = timed(lambda: scan_buckets(q_bf, ds_bf, pen, n, t, L), reps=5, warmup=1)
    plain_ms = timed(lambda: scan_buckets_plain(q_bf, ds_bf, pen, n, t, L), reps=3, warmup=1)
    lib_ms = timed(lambda: torch.matmul(q_bf, ds_bf.T), reps=5, warmup=1)
    bound, by = scan_bound(b, n, d, -(-n // t) * (t // L))
    print(f"K1 time {ms:.3f} ms, plain {plain_ms:.3f} ms, bf16 matmul yardstick "
          f"{lib_ms:.3f} ms, bound {bound:.3f} ms ({by})")
    k1 = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    k3 = k3_timing(q_bf, ds_bf, pen, n, t, L, r=32)

    # the stage profiler (K1') on the same table: its phaseA is K1 at these
    # shapes, launched through the tool's own stage functions
    fns, _ = pfs.stages(ds, q, k=10, rerank=32, l=L, tile=t)
    print(f"stage profiler at N={n} d={d} B={b} L={L} T={t} ({card()})")
    scan_buckets.launches = 0
    scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
    stage_ms = pfs.time_stages(fns, 2.0 * b * n * d, reps=2)
    torch.cuda.synchronize()
    stage_launches = scan_buckets.launches
    check(stage_launches > 0 and scan_buckets.variants["wgmma"] == stage_launches,
          "the stage profiler launched K1's wgmma variant alone")
    k1p = {"ms": stage_ms["phaseA"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": stage_ms["matmul"], "launches": stage_launches}
    return err, k1, k1p, k3, {"data": data, "ds": ds, "q": q, "gt": gt}


def k3_timing(q_bf, ds_bf, pen, n, t, L, r):
    """K3 at phase B of the 1M scan (the [B, N/L] bucket summary K1 gives,
    ids read, -> r; its block route)."""
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets

    bmin, bids = scan_buckets(q_bf, ds_bf, pen, n, t, L)
    return k3_times(bmin, r, bids, "full", "1M phase B")


def k3_times(keys, k, ids, ids_kind, tag):
    """K3 at one call: bit-equal to its plain version, then its time beside
    the plain version's, the bound (`measure.select_bound`) and `torch.topk`
    of the float keys alone (a yardstick: it fixes no order among ties, so
    it is not the same function and the port never calls it)."""
    import torch

    from flatnav_tpu_torch.bench.measure import select_bound, timed
    from flatnav_tpu_torch.ops.select_k import select_k, select_k_plain

    b, w = keys.shape
    k3_against_plain(keys, k, ids=ids, tag=tag)
    ms = timed(lambda: select_k(keys, k, ids=ids), reps=10, warmup=2)
    plain_ms = timed(lambda: select_k_plain(keys, k, ids=ids), reps=3, warmup=1)
    lib_ms = timed(lambda: torch.topk(keys, k, dim=1, largest=False), reps=5, warmup=1)
    bound, by = select_bound(b, w, k, ids=ids_kind)
    print(f"K3 at {tag}, keys [{b}, {w}] -> {k}, ids {ids_kind}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.topk yardstick {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": "torch.topk float keys", "timed_at": {"b": b, "w": w, "k": k, "ids": ids_kind}}


#: share of result slots that keep their label across reorder(["gorder",
#: "rcm"]) on the main path's index at ef_search=192; a few points under what
#: an NVIDIA H100 80GB HBM3 (700.00 W) gave, see PERF.md
REORDER_SAME_SLOTS = 0.93  # the card gave 0.9555
#: recall@10 limits of the PQ phase, a few points under what the same card
#: gave (PERF.md): the PQ graph against true neighbours and against the exact
#: ADC ranking, the raw-vector rerank at 8 bits and at the 4-bit point
PQ_GRAPH_RECALL = 0.35  # the card gave 0.3873 (the exact ADC ranking itself: 0.3695)
PQ_GRAPH_ADC_RECALL = 0.75  # the card gave 0.7966 at ef=192, 0.8631 at ef=512
PQ8_RAW_RECALL = 0.50  # rerank=64 at 1M; the card gave 0.5266
PQ8_RAW_RECALL_WIDE = 0.85  # rerank=1024; the card gave 0.8796
PQ4_RAW_RECALL = 0.19  # rerank=64; the card gave 0.2162


def phase_reorder(path):
    """Phase 5: reorder, MatrixMarket import and save / load on the main
    path's index."""
    import numpy as np
    import torch

    import flatnav_tpu_torch
    from flatnav_tpu_torch import native
    from flatnav_tpu_torch.ops.gather_distance import gather_distances

    index, queries, gt, k, ef = (path[x] for x in ("index", "queries", "gt", "k", "ef"))
    n, m = index.num_nodes, index.max_edges_per_node
    g = index.graph
    old = [t[:n].clone() for t in (g.vectors, g.links, g.labels)]
    check(torch.equal(old[2].cpu(), torch.arange(n, dtype=torch.int32)), "labels are insertion order")
    print(f"reorder: native library {'built and loaded' if native.available() else 'absent, Python path'}")
    secs = {}
    for strategy in ("gorder", "rcm"):
        t0 = time.perf_counter()
        index.reorder([strategy])
        torch.cuda.synchronize()
        secs[strategy] = time.perf_counter() - t0
    # labels were the old ids: row p now holds old node labels[p]
    perm = torch.empty(n, dtype=torch.long, device=g.vectors.device)
    perm[g.labels[:n].long()] = torch.arange(n, device=g.vectors.device)
    check(torch.equal(perm.sort().values, torch.arange(n, device=perm.device)), "a permutation")
    check(torch.equal(g.vectors[perm], old[0]) and torch.equal(g.labels[perm], old[2]),
          "rows moved by the permutation")
    check(torch.equal(g.links[perm].long(), perm[old[1].long()]), "links relabelled by the permutation")
    moved = float((perm != torch.arange(n, device=perm.device)).float().mean())

    gather_distances.launches = 0
    d2, l2 = index.search(queries, K=k, ef_search=ef)
    torch.cuda.synchronize()
    k2_launches = gather_distances.launches
    same = float((l2 == path["labels"]).mean())
    r2 = recall(l2, gt)
    print(f"reorder: gorder {secs['gorder']:.2f} s, rcm {secs['rcm']:.2f} s, {moved:.4f} of the "
          f"nodes moved; search after: recall@10 {r2:.4f} (before {path['recall']:.4f}), same label "
          f"in {same:.4f} of the slots, K2 launches {k2_launches}")
    check(k2_launches > 0, "the reordered search launched K2")
    check(abs(r2 - path["recall"]) <= 0.005, "recall@10 within 0.005 across the reorder")
    check(same >= REORDER_SAME_SLOTS, f"same labels in >= {REORDER_SAME_SLOTS} of the slots")

    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        links = g.links[:n].cpu().numpy()
        rows = np.repeat(np.arange(n, dtype=np.int64), m)
        cols = links.reshape(-1).astype(np.int64)
        keep = rows != cols
        mtx = os.path.join(tmp, "graph.mtx")
        t0 = time.perf_counter()
        with open(mtx, "w") as f:
            f.write("%%MatrixMarket matrix coordinate pattern general\n")
            f.write(f"{n} {n} {int(keep.sum())}\n")
            pairs = np.stack([rows[keep] + 1, cols[keep] + 1], axis=1)
            f.write(("%d %d\n" * len(pairs)) % tuple(pairs.ravel().tolist()))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        fresh = flatnav_tpu_torch.index.create(
            "l2", dim=index.dim, dataset_size=n, max_edges_per_node=m, device="cuda")
        fresh.allocate_nodes(g.vectors[:n].cpu().numpy(), g.labels[:n].cpu().numpy())
        fresh.build_graph_links(mtx)
        t_import = time.perf_counter() - t0
        check(torch.equal(fresh.graph.links, g.links), "imported links equal")
        d3, l3 = fresh.search(queries, K=k, ef_search=ef)
        check(np.array_equal(l3, l2) and np.array_equal(d3, d2), "imported index searches identically")
        npz = os.path.join(tmp, "reordered.npz")
        index.save(npz)
        d4, l4 = flatnav_tpu_torch.index.load_index(npz, device="cuda").search(
            queries, K=k, ef_search=ef)
        check(np.array_equal(l4, l2) and np.array_equal(d4, d2), "reloaded reordered index identical")
    print(f"import: {int(keep.sum())} edges written in {t_write:.2f} s, allocate_nodes + "
          f"build_graph_links {t_import:.2f} s; links equal, search identical; save/load identical")
    return k2_launches


def _adc_top(pq, queries, codes, k, chunk=512):
    """Exact ADC ranking: the k nearest codes of each query by
    asymmetric_distances + smallest_k, a chunk of queries at a time."""
    import torch

    from flatnav_tpu_torch.ops.distances import smallest_k

    ids = torch.arange(codes.shape[0], dtype=torch.int32, device=codes.device)[None, :]
    tops = [smallest_k(pq.asymmetric_distances(queries[lo : lo + chunk], codes), ids, k)[1]
            for lo in range(0, queries.shape[0], chunk)]
    return torch.cat(tops).cpu().numpy()


def _wall(fn):
    """-> (result, seconds) of fn() by the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_pq_graph(path):
    """Phase 6a: the PQ-coded graph index over the main path's data."""
    import numpy as np
    import torch

    from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer
    from flatnav_tpu_torch.utils.profiling import device_memory_stats

    data, queries, gt, k, ef = (path[x] for x in ("data", "queries", "gt", "k", "ef"))
    n, d = data.shape
    nq = queries.shape[0]
    m_pq, nbits, n_iters, m, efc = 16, 8, 25, 32, 100
    pq, train_s = _wall(lambda: ProductQuantizer(d, m_pq, nbits).train(data, n_iters=n_iters))
    torch.cuda.reset_peak_memory_stats()
    index = PQIndex(pq, dataset_size=n, max_edges_per_node=m)
    _, build_s = _wall(lambda: index.add(data, ef_construction=efc))
    peak = device_memory_stats()["peak_bytes_in_use"]
    (dist, lab), search_s = _wall(lambda: index.search(queries, K=k, ef_search=ef))
    check(dist.shape == (nq, k) and np.isfinite(dist).all(), "PQ graph output")
    adc_top = _adc_top(pq, queries, index._codes[:n], k)
    r_true, r_ceiling, r_adc = recall(lab, gt), recall(adc_top, gt), recall(lab, adc_top)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        file = os.path.join(tmp, "pq_index.npz")
        index.save(file)
        d2, l2 = PQIndex.load(file).search(queries, K=k, ef_search=ef)
    check(np.array_equal(lab, l2) and np.array_equal(dist, d2), "reloaded PQ index identical")
    raw_bytes = path["index"].index_memory_bytes()
    print(f"PQ graph: m_pq={m_pq} nbits={nbits} train {train_s:.2f} s ({n_iters} iterations, {n} rows), "
          f"build {build_s:.2f} s (M={m}, ef_construction={efc}), peak device memory "
          f"{peak / 1e6:.1f} MB (raw build {path['build_peak'] / 1e6:.1f} MB)")
    print(f"  search ef={ef}: {nq / search_s:.1f} qps ({search_s:.3f} s); recall@10 {r_true:.4f} against "
          f"true neighbours, exact ADC ranking {r_ceiling:.4f}, graph against the ADC ranking {r_adc:.4f}")
    print(f"  index_memory_bytes {index.index_memory_bytes() / 1e6:.1f} MB against the raw index's "
          f"{raw_bytes / 1e6:.1f} MB; save/load identical")
    (_, lab_deep), deep_s = _wall(lambda: index.search(queries, K=k, ef_search=512))
    print(f"  search ef=512: {nq / deep_s:.1f} qps; recall@10 {recall(lab_deep, gt):.4f} against true "
          f"neighbours, {recall(lab_deep, adc_top):.4f} against the ADC ranking")
    check(r_adc >= PQ_GRAPH_ADC_RECALL,
          f"PQ graph recall against the exact ADC ranking >= {PQ_GRAPH_ADC_RECALL}")
    check(recall(lab_deep, adc_top) >= r_adc, "a deeper search comes closer to the ADC ranking")
    check(r_true >= PQ_GRAPH_RECALL, f"PQ graph recall@10 >= {PQ_GRAPH_RECALL}")
    check(index.index_memory_bytes() < raw_bytes, "codes take less than raw vectors")


def phase_pq_scan(table):
    """Phase 6b: pq_scan_knn over the 1M x 128 table."""
    import numpy as np
    import torch

    from flatnav_tpu_torch.bench.measure import BF16_FLOP_PER_S, F32_FLOP_PER_S, timed
    from flatnav_tpu_torch.ops.distances import _merge_tile
    from flatnav_tpu_torch.ops.gather_distance import gather_distances
    from flatnav_tpu_torch.ops.select_k import select_k
    from flatnav_tpu_torch.quantization import ProductQuantizer, pack_codes_4bit, pack_codes_lanes
    from flatnav_tpu_torch.quantization import pq as pq_mod
    from flatnav_tpu_torch.quantization.pq import pq_scan_knn

    data, ds, q, gt = (table[x] for x in ("data", "ds", "q", "gt"))
    n, d = data.shape
    b, k, rerank, tile = q.shape[0], 10, 64, 32768
    pq8, train_s = _wall(lambda: ProductQuantizer(d, 16, 8).train(data[:100_000], n_iters=25))
    codes, enc_s = _wall(lambda: pq8.encode(ds))
    tables = pq8.adc_tables(q)
    print(f"PQ scan: N={n} B={b} m_pq=16 nbits=8 rerank={rerank} tile={tile}; train {train_s:.2f} s, "
          f"encode {enc_s:.2f} s, codes {codes.numel() / 1e6:.1f} MB")

    def scan(c, t, **kw):
        (dist, ids), sec = _wall(lambda: pq_scan_knn(c, t, k, rerank=rerank, tile_size=tile, **kw))
        return dist.cpu().numpy(), ids.cpu().numpy(), sec

    scan(codes, tables)  # warm-up: cuBLAS picks its kernels
    gather_distances.launches = 0
    _, raw_ids, raw_s = scan(codes, tables, vectors=ds, queries=q)
    k2_launches = gather_distances.launches
    check(k2_launches > 0, "the raw-vector rerank launched K2")
    r_raw = recall(raw_ids, gt)
    adc_d, adc_ids, adc_s = scan(codes, tables)
    sub = 512  # the exact ADC ranking of a [sub, N] block fits comfortably
    want = _adc_top(pq8, q[:sub], codes, k, chunk=128)
    adc_same = float((adc_ids[:sub] == want).mean())
    print(f"  8-bit: raw-vector rerank recall@10 {r_raw:.4f}, {b / raw_s:.1f} qps ({raw_s:.3f} s); "
          f"ADC rerank {b / adc_s:.1f} qps ({adc_s:.3f} s), recall@10 {recall(adc_ids, gt):.4f}, ids "
          f"equal to the exact ADC top-{k} in {adc_same:.4f} of the slots ({sub} queries)")
    # the shortlist bounds the raw-vector rerank's recall: wider shortlists
    wide = {}
    for r_wide in (256, 1024):
        (_, ids_w), sec_w = _wall(lambda: pq_scan_knn(
            codes, tables, k, rerank=r_wide, tile_size=tile, vectors=ds, queries=q))
        wide[r_wide] = recall(ids_w.cpu().numpy(), gt)
        print(f"  8-bit: raw-vector rerank at rerank={r_wide}: recall@10 {wide[r_wide]:.4f}, "
              f"{b / sec_w:.1f} qps ({sec_w:.3f} s)")
    check(r_raw >= PQ8_RAW_RECALL, f"8-bit raw-rerank recall@10 >= {PQ8_RAW_RECALL} at rerank={rerank}")
    check(r_raw <= wide[256] <= wide[1024], "a wider shortlist never lowers the recall")
    check(wide[1024] >= PQ8_RAW_RECALL_WIDE, f"8-bit raw-rerank recall@10 >= {PQ8_RAW_RECALL_WIDE} at rerank=1024")
    check(adc_same >= 0.99, "ADC-rerank ids equal to the exact ADC top-10 in >= 99% of slots")

    flat, n_pad = pack_codes_lanes(codes.cpu().numpy(), tile=tile)
    _, lane_ids, lane_s = scan(torch.from_numpy(flat).cuda(), tables, n_valid=n, lane_packed=True)
    check(np.array_equal(lane_ids, adc_ids), "lane_packed ids identical to unpacked")
    print(f"  lane_packed ({n_pad} padded rows): ids identical to unpacked ({lane_s:.3f} s)")

    pq4 = ProductQuantizer(d, 16, 4).train(data[:100_000], n_iters=25)
    codes4 = pack_codes_4bit(pq4.encode(ds))
    tables4 = pq4.adc_tables(q)
    scan(codes4, tables4, packed_4bit=True)
    _, ids4, s4 = scan(codes4, tables4, vectors=ds, queries=q, packed_4bit=True)
    r4 = recall(ids4, gt)
    print(f"  4-bit, two codes a byte ({codes4.shape[1]} bytes a node): raw-vector rerank recall@10 "
          f"{r4:.4f}, {b / s4:.1f} qps ({s4:.3f} s)")
    check(r4 >= PQ4_RAW_RECALL, f"4-bit raw-rerank recall@10 >= {PQ4_RAW_RECALL}")

    # the scan's stages at the 8-bit shapes, each over all tiles of the table
    s, nc = tables.shape[1], tables.shape[2]
    t_bf = tables.reshape(b, s * nc).to(torch.bfloat16)
    sub_base = torch.arange(s, device=codes.device) * nc
    onehot = torch.empty((tile, s * nc), dtype=torch.bfloat16, device=codes.device)
    starts = [min(s0, n - tile) for s0 in range(0, n, tile)]

    def fill(start):
        return onehot.zero_().scatter_(1, codes[start : start + tile].long() + sub_base, 1.0)

    key = pq_mod._scan_keys_bf16(t_bf, fill(0))
    best = select_k(key, rerank)

    def per_tile(fn):
        def run():
            for st in starts:
                fn(st)
        return run

    ms = {
        "one-hot": timed(per_tile(fill), reps=2, warmup=1),
        "keys, bf16 product with f32 result": timed(
            per_tile(lambda st: pq_mod._scan_keys_bf16(t_bf, onehot)), reps=2, warmup=1),
        "keys, f32 matmul of the rounded operands": timed(
            per_tile(lambda st: pq_mod._scan_keys_f32(t_bf, onehot)), reps=1, warmup=1),
        "shortlist (K3: one launch a tile, seeded with the running r)": timed(
            per_tile(lambda st: _merge_tile(best[0], best[1], key, st, (0, tile))),
            reps=2, warmup=1),
    }
    ops = 2.0 * n * s * nc * b
    print(f"  scan stages over {len(starts)} tiles (ms): " + "; ".join(f"{k_} {v:.3f}" for k_, v in ms.items()))
    print(f"  operations 2 N S nc B = {ops:.3e}: bound {ops / BF16_FLOP_PER_S * 1e3:.3f} ms at the bf16 "
          f"peak, {ops / F32_FLOP_PER_S * 1e3:.3f} ms at the f32 peak")
    # the rejected route end to end, in the same process
    shipped = pq_mod._scan_keys
    pq_mod._scan_keys = pq_mod._scan_keys_f32
    try:
        _, f32_ids, f32_s = scan(codes, tables)
    finally:
        pq_mod._scan_keys = shipped
    print(f"  pq_scan_knn with f32-matmul keys: {f32_s:.3f} s against {adc_s:.3f} s; ids equal in "
          f"{float((f32_ids == adc_ids).mean()):.4f} of the slots")
    check(float((f32_ids == adc_ids).mean()) >= 0.99, "both key routes rank alike")
    return k2_launches


def _in_process(main, argv) -> str:
    """Run a module's `main(argv)` in this process; -> what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _subprocess(argv, what, timeout=600):
    """Run `python argv` from the checkout; a nonzero exit fails the smoke."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, *argv], capture_output=True, text=True, timeout=timeout,
                       cwd=REPO, env=env)
    check(r.returncode == 0, f"{what} exits 0; its errors end: {r.stderr[-1500:]}")
    return r.stdout


def phase_harness(path):
    """Phase 7: run_benchmark over files of the main path's data, then the
    construct and query CLIs. -> (K1 launches, K2 launches) of the harness."""
    import math

    import numpy as np

    from flatnav_tpu_torch.bench import run_benchmark
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances
    from flatnav_tpu_torch.tools import construct as construct_cli
    from flatnav_tpu_torch.tools import query as query_cli

    data, queries, gt, k = (path[x] for x in ("data", "queries", "gt", "k"))
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        files = {name: os.path.join(tmp, f"{name}.npy") for name in ("train", "queries", "gtruth")}
        np.save(files["train"], data)
        np.save(files["queries"], queries)
        np.save(files["gtruth"], gt.astype(np.int32))
        fbin = {name: os.path.join(tmp, f"{name}.fbin") for name in ("train", "queries")}
        for name, arr in (("train", data), ("queries", queries)):
            with open(fbin[name], "wb") as f:
                f.write(np.asarray(arr.shape, np.int32).tobytes())
                f.write(arr.tobytes())
        gt_bin = os.path.join(tmp, "gtruth.bin")
        with open(gt_bin, "wb") as f:
            f.write(np.asarray(gt.shape, np.int32).tobytes())
            f.write(gt.astype(np.int32).tobytes())
            f.write(np.zeros(gt.shape, np.float32).tobytes())

        def bench(index_type, ef_search, src=files, gtruth=None, extra=()):
            return run_benchmark.main([
                "--dataset", src["train"], "--queries", src["queries"],
                "--gtruth", gtruth or files["gtruth"], "--metric", "l2",
                "--index-type", index_type, "--num-node-links", "32",
                "--ef-construction", "100", "--ef-search", *map(str, ef_search),
                "--k", str(k), "--batch-size", "2048", "--no-plot",
                "--metrics-file", os.path.join(tmp, f"metrics_{index_type}.json"), *extra])

        gather_distances.launches = 0
        scan_buckets.launches = 0
        rows = bench("flatnav", (64, 128, 192, 256))
        rows += bench("flatnav-fused", (0,))
        rows += bench("flatnav-fusednr", (0,))
        rows += bench("flatnav-exact", (0,), src=fbin, gtruth=gt_bin)
        mem_log = os.path.join(tmp, "memory.jsonl")
        rows += bench("flatnav-pq-scan", (0,), extra=("--memory-log", mem_log))
        k1_launches, k2_launches = scan_buckets.launches, gather_distances.launches
        with open(mem_log) as f:
            mem = [json.loads(line) for line in f]
        check(mem and mem[-1]["device"].get("bytes_in_use", 0) > 0, "the memory log sampled the card")

        print(f"harness: N={data.shape[0]} d={data.shape[1]} M=32 ef_construction=100 K={k} "
              f"{queries.shape[0]} queries in batches of 2048; K1 launches {k1_launches}, "
              f"K2 launches {k2_launches}")
        for row in rows:
            check(all(name in row and math.isfinite(row[name]) for name in run_benchmark.DEFAULT_METRICS),
                  f"every default metric of {row['index_type']} is present and finite")
            check(row["latency_p50"] <= row["latency_p90"] <= row["latency_p95"]
                  <= row["latency_p99"] <= row["latency_p999"], "latency percentiles ordered")
            check(row["distance_computations"] > 0 and row["qps"] > 0, "counted work")
            print(f"  {row['index_type']} ef={row['ef_search']}: recall {row['recall']:.4f}  "
                  f"qps {row['qps']:.1f}  p50 {row['latency_p50']:.3f} ms  p999 "
                  f"{row['latency_p999']:.3f} ms  dist comps/query "
                  f"{row['distance_computations']:.1f}  index {row['index_size'] / 1e6:.1f} MB  "
                  f"build {row['build_time']:.2f} s")
        by = {(r["index_type"], r["ef_search"]): r["recall"] for r in rows}
        graph = [by[("flatnav", ef)] for ef in (64, 128, 192, 256)]
        check(by[("flatnav-exact", 0)] == 1.0, "harness exact recall == 1.0")
        check(by[("flatnav-fused", 0)] >= 0.98, "harness fused recall >= 0.98")
        check(by[("flatnav", 192)] >= 0.90, "harness graph recall >= 0.90 at ef=192")
        check(graph == sorted(graph), "harness graph recall does not decrease in ef")
        check(k1_launches > 0 and k2_launches > 0, "the harness launched K1 and K2")

        index_file = os.path.join(tmp, "cli_index.npz")
        t0 = time.perf_counter()
        out = _in_process(construct_cli.main, ["0", files["train"], "32", "100", index_file])
        check("saved index" in out, "tools.construct saved the index")
        built = [ln for ln in out.splitlines() if ln.startswith("build time")]
        print(f"CLI construct: {built[0]} ({time.perf_counter() - t0:.1f} s in this process)")
        query = ["-m", "flatnav_tpu_torch.tools.query", index_file, files["queries"], files["gtruth"],
                 "--ef-search", "100", "200", "--k", str(k)]
        for extra in ((), ("--reorder",)):
            # the first run as `python -m`, the second in this process
            out = (_in_process(query_cli.main, [*query[2:], *extra]) if extra
                   else _subprocess(query, "tools.query"))
            lines = [ln for ln in out.splitlines() if ln.startswith("ef_search=")]
            check(len(lines) == 2, "tools.query printed one line per ef_search")
            recalls = [float(ln.split(f"recall@{k}=")[1].split()[0]) for ln in lines]
            check(recalls[1] >= 0.90 and recalls[1] >= recalls[0], "tools.query recall")
            print(f"CLI query{' --reorder' if extra else ''}: " + " | ".join(lines))
    return k1_launches, k2_launches


def phase_headline():
    """Phase 8: the headline benchmark (`main` in this process), then one graph point
    of its saved index with the search options. -> (its line, K2 max abs
    error at the compacted hop)"""
    import numpy as np
    import torch

    from flatnav_tpu_torch.bench import headline
    from flatnav_tpu_torch.bench._northstar import recorded_hop
    from flatnav_tpu_torch.index.serialize import load_index
    from flatnav_tpu_torch.ops import brute_force_knn
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances

    with open(os.path.join(REPO, "baseline_ref.json")) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        saved = ["--index", os.path.join(tmp, "headline_index.npz"),
                 "--queries-file", os.path.join(tmp, "headline_queries.npy")]
        t0 = time.perf_counter()
        scan_buckets.launches = 0
        gather_distances.launches = 0
        out = _in_process(headline.main, saved)
        line = json.loads(out.strip().splitlines()[-1])
        print(f"headline ({time.perf_counter() - t0:.1f} s): {json.dumps(line)}")
        check("engine_faults" not in line, "no engine_faults key")
        check(line["workload_key"] == ref["workload_key"] and line["baseline_qps"] == ref["qps"],
              "the headline's baseline is baseline_ref.json's (the workload key matches)")
        check(line["vs_baseline"] == round(line["value"] / ref["qps"], 2), "vs_baseline")
        check(line["exact_recall"] == 1.0, "headline exact recall == 1.0")
        check(line["fused_recall"] >= 0.98 and line["fusednr_recall"] >= 0.98
              and line["fast_recall"] >= 0.98, "headline scan recalls >= 0.98")
        check(line["graph_recall"] >= 0.95, "headline graph point meets the target")
        check(line["recall"] >= 0.95, "the winner's recall >= 0.95")
        check(line["mfu"] is None or line["mfu"] <= 1, "mfu <= 1")
        check(all(v is None or v <= 1 for v in line["engine_mfu"].values()), "engine mfu <= 1")
        check(line["kernel_launches"]["scan_buckets"] > 0
              and line["kernel_launches"]["gather_distances"] > 0, "the headline launched K1 and K2")

        # the graph point it chose, at E=64 on the index it saved
        g, metric, _ = load_index(saved[1])
        q = torch.from_numpy(np.load(saved[3])).cuda()
        _, gt = brute_force_knn(g.vectors[: g.num_nodes], q, 10, metric)
        gt = gt.cpu().numpy()
        ef, m = line["ef_search"], g.links.shape[1]
        with recorded_hop(512, nth=3) as rec:
            for name, opts in (("full", {}), ("m_search=16", {"ms": 16}),
                               ("compact_width=512", {"cw": 512})):
                def run():
                    return headline._run_graph(g, metric, q, 10, 4096, ef, 64, **opts)

                rec.reset()
                gather_distances.launches = 0
                labels, _ = run()
                launches = gather_distances.launches
                qps = headline._best_qps(run, q.shape[0], 3)
                print(f"  graph E=64 ef={ef} M={m} {name}: recall@10 {recall(labels, gt):.4f}  "
                      f"qps {qps:.1f}  K2 launches {launches}")
                check(launches > 0, f"the {name} search launched K2")
    check(rec.args is not None and tuple(rec.args[1].shape) == (4096, 512),
          "a compacted hop of C=512 was recorded")
    k2_err = k2_against_plain(*rec.args, "compacted hop, C=512")
    print("  K2 at a compacted hop B x C = (4096, 512): bit-equal to the plain version")
    return line, k2_err


def phase_routed_scan():
    """Phase 9: the routed scan's bounds, recall and time at the tool's
    defaults."""
    from flatnav_tpu_torch.bench import profile_routed_scan

    with open(os.path.join(REPO, "benchmarks", "results_routed_scan.json")) as f:
        recorded = json.load(f)["clustered_default"]["end_to_end"]
    t0 = time.perf_counter()
    out = profile_routed_scan.profile()
    print(f"routed scan ({time.perf_counter() - t0:.1f} s): {json.dumps(out)}")
    check(out["full_union_recall"] == 1.0, "the full union equals brute_force_knn")
    check(len(out["end_to_end"]) == len(recorded), "every recorded setting ran")
    for got, want in zip(out["end_to_end"], recorded):
        check(all(got[x] == want[x] for x in ("probes", "union", "group")), "the same settings")
        check(abs(got["recall"] - want["recall"]) <= 0.02,
              f"routed recall {got['recall']} within 0.02 of the recorded {want['recall']}")
        print(f"  P={got['probes']} U={got['union']} G={got['group']}: recall {got['recall']:.4f} "
              f"(recorded {want['recall']:.4f}), routed_knn {got['routed_knn_ms']:.3f} ms against "
              f"fast_knn {out['fast_knn_ms']:.3f} ms (recall {out['fast_knn_recall']:.4f})")


#: rows of the main path's data the phase-10 builds take: every wave of the
#: model-sharded build sends its candidate rows and back-edge targets through
#: gloo, which several ranks on one card need (PERF.md)
SHARDED_BUILD_ROWS = 10_000


def phase_sharded(path):
    """Phase 10: parallel/ on the main path's graph, data and queries. A (1, 1)
    NCCL mesh runs every sharded function; four gloo ranks on the one card run
    the model-sharded search, build, exact, fused and PQ scans on (1, 4) and
    the data-parallel search and replicated build on (2, 2); then the dry run
    at 4 ranks. Every result must equal the single-device port's on the same
    inputs (the two-phase scans: the same engine shard by shard). ->
    {run: {case: [per-rank launches]}} for K1 and for K2."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from flatnav_tpu_torch.bench.measure import CallRecorder
    from flatnav_tpu_torch.data_type import to_numpy
    from flatnav_tpu_torch.index.build import add_batch
    from flatnav_tpu_torch.index.graph import make_empty_graph
    from flatnav_tpu_torch.index.search import batched_search
    from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fused_knn
    from flatnav_tpu_torch.ops import fused_scan as fused_mod
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets, scan_variant
    from flatnav_tpu_torch.ops.gather_distance import gather_distances
    from flatnav_tpu_torch.parallel import run_ranks
    from flatnav_tpu_torch.parallel.dryrun import run_cases, run_meshes
    from flatnav_tpu_torch.parallel.sharded_exact import shards_on_one_device
    from flatnav_tpu_torch.quantization import ProductQuantizer
    from flatnav_tpu_torch.quantization.pq import pq_scan_knn

    g, data, queries, k, ef = (path[x] for x in ("index", "data", "queries", "k", "ef"))
    g = g.graph
    n, d, m = g.num_nodes, g.dim, g.max_edges
    e_f, efc, nb = 16, 100, SHARDED_BUILD_ROWS
    q = torch.from_numpy(queries).cuda()
    graph = {"vectors": to_numpy(g.vectors), "links": to_numpy(g.links), "labels": to_numpy(g.labels),
             "num_nodes": n, "capacity": g.capacity}
    pq = ProductQuantizer(d, 16, 8).train(data, n_iters=25)
    codes = pq.encode(g.vectors[:n])
    tables = pq.adc_tables(q)
    table_n = graph["vectors"][:n]
    args = {
        "search": {"op": "search", "args": {"graph": graph, "queries": queries, "k": k, "ef": ef,
                                            "expand_factor": e_f}},
        "dp_search": {"op": "dp_search", "args": {"graph": graph, "queries": queries, "k": k, "ef": ef}},
        "exact": {"op": "exact", "args": {"vectors": table_n, "num_nodes": n, "queries": queries, "k": k}},
        "fused": {"op": "exact", "args": {"vectors": table_n, "num_nodes": n, "queries": queries, "k": k,
                                          "rerank": 32, "fused": True}},
        "pq": {"op": "pq", "args": {"codes": codes.cpu().numpy(), "tables": tables.cpu().numpy(),
                                    "num_nodes": n, "k": k, "rerank": 64, "vectors": table_n,
                                    "queries": queries}},
    }
    for spec in ("model", "replicated"):
        args[f"build_{spec}"] = {"op": "build", "args": {
            "data": data[:nb], "capacity": nb, "max_edges": m, "ef_construction": efc,
            "metric": MetricType.L2, "table_spec": spec}}
    runs = {"nccl 1x1": ("nccl", (1, 1), list(args)),
            "gloo 1x4": ("gloo", (1, 4), ["search", "exact", "fused", "pq", "build_model"]),
            "gloo 2x2": ("gloo", (2, 2), ["dp_search", "build_replicated"])}
    #: the gloo meshes and the dry run share one start of four ranks
    gloo_runs = [run for run, (backend, _, _) in runs.items() if backend == "gloo"]

    # the single-device port on the same inputs; K1 on the first shard of
    # the (1, 4) fused scan is recorded on the way
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = torch.from_numpy(table_n).cuda()
    rec = CallRecorder(scan_buckets, lambda qb, rows, *rest: rows.shape[0] < n)
    fused_mod.scan_buckets = rec
    try:
        want = {
            "search": batched_search(g.vectors, g.links, g.labels, n, q, k=k, ef=ef, expand_factor=e_f),
            "dp_search": batched_search(g.vectors, g.links, g.labels, n, q, k=k, ef=ef),
            "exact": brute_force_knn(table, q, k),
            "fused 1": fused_knn(table, q, k, rerank=32),
            "fused 4": shards_on_one_device(
                lambda r, nv: fused_knn(r, q, k, rerank=32, n_valid=nv), table, n, 4, k),
        }
    finally:
        fused_mod.scan_buckets = scan_buckets
    for nm in (1, 4):
        want[f"pq {nm}"] = shards_on_one_device(
            lambda rows, nv: pq_scan_knn(codes[rows[:, 0]], tables, k, rerank=64, n_valid=nv,
                                         vectors=table[rows[:, 0]], queries=q),
            torch.arange(n, device="cuda")[:, None], n, nm, k)
    built = add_batch(make_empty_graph(nb, d, m), data[:nb], np.arange(nb), ef_construction=efc,
                      metric=MetricType.L2)
    want_links = to_numpy(built.links)[: built.vectors.shape[0]]
    torch.cuda.synchronize()
    print(f"sharded: single-device references in {time.perf_counter() - t0:.1f} s; builds of "
          f"{nb} rows of the main data (M={m}, ef_construction={efc}), searches of {len(queries)} "
          f"queries at ef={ef} (model-sharded E={e_f}, data-parallel E=1)")

    launches = {"scan_buckets": {}, "gather_distances": {}}
    # the one NCCL rank is this process: a group of one, torn down after
    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(rdv, "rendezvous"),
                                rank=0, world_size=1)
        try:
            results = {"nccl 1x1": run_cases([args[x] for x in runs["nccl 1x1"][2]], 1, 1, "cuda")}
        finally:
            dist.destroy_process_group()
    print(f"  nccl 1x1: {time.perf_counter() - t0:.1f} s in this process")
    t0 = time.perf_counter()
    gloo = run_ranks(run_meshes, 4, backend="gloo", device="cuda", timeout=900,
                     args=([(*runs[r][1], [args[x] for x in runs[r][2]]) for r in gloo_runs], "cuda",
                           True))
    results.update(zip(gloo_runs, gloo))
    dry = gloo[-1]
    print(f"  {' and '.join(gloo_runs)} and the dry run at 4 ranks on a {dry['mesh']} mesh (every "
          f"step checked): {time.perf_counter() - t0:.1f} s with one start of the four ranks")
    for run, (backend, shape, names) in runs.items():
        print(f"  {run}:")
        for name, out in zip(names, results[run]):
            nm = shape[1]
            if name in ("search", "dp_search"):
                ref = want[name]
                check(np.array_equal(out["labels"], ref.labels.cpu().numpy()), f"{run} {name} labels")
                check(np.allclose(out["dists"], ref.dists.cpu().numpy(), rtol=0, atol=1e-5),
                      f"{run} {name} distances")
                check((out["dist_computations"], out["hops"]) == (ref.dist_computations, ref.hops),
                      f"{run} {name} counters")
            elif name.startswith("build"):
                check(np.array_equal(out["links"], want_links) and out["num_nodes"] == nb,
                      f"{run} {name} links")
            else:
                ref = want[name] if name == "exact" else want[f"{name} {nm}"]
                check(np.array_equal(out["ids"], ref[1].cpu().numpy()), f"{run} {name} ids")
                check(np.allclose(out["dists"], ref[0].cpu().numpy(), rtol=0, atol=1e-5),
                      f"{run} {name} distances")
            per_rank = out["launches"].tolist()
            launches["scan_buckets"][f"{run} {name}"] = [r[0] for r in per_rank]
            launches["gather_distances"][f"{run} {name}"] = [r[1] for r in per_rank]
            print(f"    {name}: {out['seconds']:.3f} s, equal to the single device; launches per rank "
                  f"(K1, K2) {per_rank}")
            kernel = "scan_buckets" if name == "fused" else "gather_distances"
            if name not in ("exact",):
                check(all(x > 0 for x in launches[kernel][f"{run} {name}"]), f"{run} {name} launched {kernel}")
    fused_1 = want["fused 1"][1].cpu().numpy()
    print(f"  fused over 4 shards against one scan of the table: ids equal in "
          f"{float((want['fused 4'][1].cpu().numpy() == fused_1).mean()):.4f} of the slots "
          f"(each shard keeps its own shortlist)")

    # the kernels at the shapes only the shards give them: K1 on a shard's
    # rows, K2 scoring a shard's table
    qb, rows, pen, nlim, t, L = rec.args
    variant = scan_variant(qb, rows, pen, t, L)
    check(rec.args is not None, "K1 was recorded on a shard")
    k1_err = k1_against_plain(*rec.args, "a (1, 4) shard")
    n_local = -(-g.vectors.shape[0] // 4)
    ids = torch.randint(0, n_local, (len(queries), e_f * m), dtype=torch.int32, device="cuda")
    k2_err = k2_against_plain(g.vectors[:n_local], ids, q, MetricType.L2, "a (1, 4) shard's rows")
    print(f"  K1 on a (1, 4) shard: rows {tuple(rows.shape)} n_valid {nlim} T={t} L={L} "
          f"({variant}), max abs err {k1_err:g}; K2 on a shard of {n_local} rows, B x C = "
          f"{tuple(ids.shape)}: bit-equal")
    return launches, k1_err, k2_err


#: phase 11: rows of the north-star runs, queries of each, and the one graph
#: point each northstar run takes (ef, expand factor)
NS_ROWS, NS_QUERIES, NS_GRAPH_POINT = 100_000, 2048, (256, 16)
#: recall@10 floors of phase 11, a few points under what an NVIDIA H100 80GB
#: HBM3 (700.00 W) gave at these rows and NS_QUERIES queries, in the whole
#: smoke from a `git archive` of the tree (PERF.md): {run: {engine: floor}}
NS_FLOORS = {
    # exact 1.0, fast 1.0, fused 0.9993, fusednr 0.9944, graph 0.9864
    "angular": {"exact": 1.0, "fast": 0.99, "fused": 0.98, "fusednr": 0.98, "graph": 0.96},
    # exact 1.0, fast 1.0, fused 0.9995, fusednr 0.9948, graph 0.9844
    "gist": {"exact": 1.0, "fast": 0.99, "fused": 0.98, "fusednr": 0.98, "graph": 0.96},
    # exact 1.0, fast 1.0, fused 0.9992, fusednr 0.9992, graph 0.9603, pq
    # 0.9561 (rerank 512), pq4 0.7745 (rerank 1024)
    "bigann 10M": {"exact": 1.0, "fast": 0.99, "fused": 0.98, "fusednr": 0.98, "graph": 0.93,
                   "pq": 0.93, "pq4": 0.74},
    # exact 1.0, fused 0.9999, fusednr 0.9999
    "bigann 100M": {"exact": 1.0, "fused": 0.98, "fusednr": 0.98},
}


#: the K1 variant each north-star run must take, and no other
NS_VARIANTS = {"angular": "wgmma", "gist": "wgmma_wide", "bigann 10M": "wgmma_int8",
               "bigann 100M": "wgmma_int8"}


def phase_northstar():
    """Phase 11: the north-star runners through `main(argv)` at a small
    scale, in a scratch directory that is removed after: angular (d=100,
    IP over normalised rows) and gist (d=960) at NS_ROWS rows with one graph
    point, the BigANN-class 10M runner at NS_ROWS uint8 rows (graph, scans,
    PQ at 8 and 4 bits), the 100M runner at 1M rows with its scan engines.
    Kernel counts are zeroed before each run and read after it. Every
    engine's recall is held to NS_FLOORS; K1 must launch the variant
    NS_VARIANTS names and no other (never "mma") in each run, and K2 in the
    float graphs; the kernels alone at each run's
    shapes come from the runners (`_northstar.k1_times` / `k2_times`: K1
    within the bf16 tolerance of its plain version, bit-equal on 8-bit rows,
    K2 bit-equal). -> {run: {"launches", "kernels", "seconds"}}."""
    import contextlib

    from flatnav_tpu_torch.bench import bigann_10m, bigann_100m, northstar
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances

    n, nq = str(NS_ROWS), str(NS_QUERIES)
    runs = [
        ("angular", northstar, ["--config", "angular", "--n", n, "--efc", "200",
                                "--centers-per-64k", "26"]),
        ("gist", northstar, ["--config", "gist", "--n", n, "--efc", "100", "--centers-per-64k", "26"]),
        ("bigann 10M", bigann_10m, ["--n", n, "--nq", nq]),
        ("bigann 100M", bigann_100m, ["--n", "1000000", "--nq", nq, "--b", nq, "--no-pq"]),
    ]
    saved = {"scratch": os.environ.get("FLATNAV_SCRATCH"), "nq": northstar.NQ,
             "ef": northstar.EF_SWEEP, "e": northstar.E_SWEEP,
             "ef10": bigann_10m.EF_GRID, "e10": bigann_10m.E_GRID}
    out = {}
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        os.environ["FLATNAV_SCRATCH"] = tmp
        northstar.NQ = NS_QUERIES
        northstar.EF_SWEEP, northstar.E_SWEEP = (NS_GRAPH_POINT[0],), (NS_GRAPH_POINT[1],)
        bigann_10m.EF_GRID, bigann_10m.E_GRID = (NS_GRAPH_POINT[0],), (NS_GRAPH_POINT[1],)
        try:
            for name, mod, argv in runs:
                gather_distances.launches = 0
                scan_buckets.launches = 0
                scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
                t0 = time.perf_counter()
                with open(os.path.join(tmp, "runner.log"), "a") as log, \
                        contextlib.redirect_stdout(log):
                    res = mod.main([*argv, "--results-dir", tmp])
                sec = time.perf_counter() - t0
                launches = {"gather_distances": gather_distances.launches,
                            "scan_buckets": scan_buckets.launches,
                            "scan_buckets variants": dict(scan_buckets.variants)}
                out[name] = {"launches": launches, "kernels": res.get("kernels"), "seconds": sec,
                             "result": res}
        finally:
            northstar.NQ, northstar.EF_SWEEP, northstar.E_SWEEP = saved["nq"], saved["ef"], saved["e"]
            bigann_10m.EF_GRID, bigann_10m.E_GRID = saved["ef10"], saved["e10"]
            if saved["scratch"] is None:
                os.environ.pop("FLATNAV_SCRATCH", None)
            else:
                os.environ["FLATNAV_SCRATCH"] = saved["scratch"]

    for name, run in out.items():
        res, floors, launches = run["result"], NS_FLOORS[name], run["launches"]
        recalls = {e: res[f"{e}_engine"]["recall"] for e in ("exact", "fast", "fused", "fusednr")
                   if res.get(f"{e}_engine")}
        if res.get("sweep"):
            recalls["graph"] = res["sweep"][0]["recall"]
        for key, e in (("pq", "pq_scan_engine"), ("pq4", "pq4_scan_engine")):
            if res.get(e):
                recalls[key] = res[e]["recall"]
        qps = {e: res[f"{e}_engine"]["qps"] for e in ("exact", "fast", "fused", "fusednr")
               if res.get(f"{e}_engine")}
        build = (f"build {res['build_seconds']} s, build peak {res['build_peak_bytes'] / 1e6:.1f} MB"
                 if "build_seconds" in res else "no build")
        print(f"north star {name} ({run['seconds']:.1f} s): {res['workload']}; {build}; "
              f"launches {launches}")
        print("  recall@10 " + ", ".join(f"{e} {r:.4f}" for e, r in recalls.items())
              + "; qps " + ", ".join(f"{e} {q:.1f}" for e, q in qps.items()))
        if res.get("graph_operating_point"):
            print(f"  graph point {res['graph_operating_point']}")
        for e, floor in floors.items():
            check(recalls[e] >= floor, f"north star {name}: {e} recall {recalls[e]} >= {floor}")
        want = NS_VARIANTS[name]
        variants = launches["scan_buckets variants"]
        check(variants[want] > 0 and variants["mma"] == 0 and sum(variants.values()) == variants[want],
              f"north star {name} launched K1's {want} variant alone: {variants}")
        if name in ("angular", "gist"):
            check(launches["gather_distances"] > 0, f"north star {name} launched K2")
        for kname, k in (run["kernels"] or {}).items():
            if k:
                print(f"  {kname} alone: " + json.dumps(k))
        k1 = (run["kernels"] or {}).get("scan_buckets")
        check(k1 is not None and k1["variant"] == want, f"north star {name}: K1 timed on {want}")
        # 8-bit rows were held bit-equal inside the runner; bf16 ones here
        check(k1["max_abs_err"] <= 1e-5 * k1["key_max"],
              f"north star {name}: K1 within 1e-5 of its largest key of the plain version")
    return out


#: phase 12: (name, rows, d, row type, metric, the K1 variant fused_knn
#: must take alone); MS SPACEV's 10M slice and GloVe-25 / -50 at the
#: reference datasets' shapes, types and metrics
NEW_SHAPES = [
    ("spacev-10M", 10_000_000, 100, "int8", "l2", "wgmma_int8_packed"),
    ("glove-25", 1_183_514, 25, "float32", "ip", "wgmma_narrow"),
    ("glove-50", 1_183_514, 50, "float32", "ip", "wgmma"),
    # a BigANN-class uint8 table searched with float32 queries (table rows
    # plus normal noise), which K1 takes as bf16 against the 8-bit rows
    ("bigann-10M-floatq", 10_000_000, 128, "uint8", "l2", "wgmma_mixed"),
]
#: spread of the noise added to phase 12's float queries of a uint8 table
FLOATQ_NOISE = 8.0
NEW_QUERIES = 4096
#: recall@10 of fused_knn (rerank 32) against brute_force_knn, first 256
#: queries: buckets of L=256 / 32 rows lose a true neighbour only on a
#: collision of two in one bucket or (bf16) a key error past the 32nd bucket
NEW_FLOOR = 0.98


def phase_new_shapes():
    """Phase 12 (see the module's docstring). -> {name: {"variant",
    "launches", "recall", "seconds", "kernel"}}, "kernel" being
    `_northstar.k1_times` at that shape (beside "mma" where K1 takes
    "wgmma_mixed")."""
    import torch

    from flatnav_tpu_torch.bench._northstar import k1_times
    from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fused_knn
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets

    dev = torch.device("cuda")
    out = {}
    for i, (name, n, d, kind, metric, want) in enumerate(NEW_SHAPES):
        g = torch.Generator(device=dev).manual_seed(0x5BACE + i)
        m = MetricType.L2 if metric == "l2" else MetricType.IP
        if kind == "int8":
            data = torch.randint(-128, 128, (n, d), dtype=torch.int8, device=dev, generator=g)
            q = torch.randint(-128, 128, (NEW_QUERIES, d), dtype=torch.int8, device=dev,
                              generator=g)
        elif kind == "uint8":
            data = torch.randint(0, 256, (n, d), dtype=torch.uint8, device=dev, generator=g)
            src = torch.randint(0, n, (NEW_QUERIES,), device=dev, generator=g)
            q = data[src].float() + FLOATQ_NOISE * torch.randn(
                (NEW_QUERIES, d), device=dev, generator=g)
        else:
            data = torch.randn((n, d), device=dev, generator=g)
            data /= data.norm(dim=1, keepdim=True)
            q = torch.randn((NEW_QUERIES, d), device=dev, generator=g)
            q /= q.norm(dim=1, keepdim=True)
        torch.cuda.synchronize()
        scan_buckets.launches = 0
        scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
        t0 = time.perf_counter()
        fd, fi = fused_knn(data, q, 10, m, rerank=32)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        variants = dict(scan_buckets.variants)
        check(variants[want] > 0 and sum(variants.values()) == variants[want],
              f"{name}: fused_knn launched K1's {want} variant alone: {variants}")
        check(tuple(fd.shape) == (NEW_QUERIES, 10) and bool(torch.isfinite(fd).all()),
              f"{name}: fused_knn gave finite distances of shape ({NEW_QUERIES}, 10)")
        _, truth = brute_force_knn(data, q[:256], 10, m)
        rec = recall(fi[:256].cpu().numpy(), truth.cpu().numpy())
        check(rec >= NEW_FLOOR, f"{name}: fused recall@10 {rec} >= {NEW_FLOOR}")
        kernel = k1_times(data, q, m, also=("mma",) if want == "wgmma_mixed" else ())
        check(kernel["variant"] == want, f"{name}: K1 timed on {want}")
        # int8 rows and queries were held bit-equal inside k1_times; bf16
        # queries here
        check(kernel["max_abs_err"] <= 1e-5 * kernel["key_max"],
              f"{name}: K1 within 1e-5 of its largest key of the plain version")
        check(kernel["ids_equal"] >= 0.99, f"{name}: K1 ids equal the plain version's on 99%")
        print(f"{name} ({n} x {d} {kind}, {metric}): fused_knn {sec:.3f} s (first call), "
              f"recall@10 {rec:.4f}, K1 launches {variants}; K1 alone: {json.dumps(kernel)}")
        out[name] = {"variant": want, "launches": variants[want], "recall": rec, "seconds": sec,
                     "kernel": kernel}
        del data, q, fd, fi, truth
        torch.cuda.empty_cache()
    return out


#: phase 13: the Index at OpenAI's d = 1536 (angular: IP over unit rows),
#: cut to OPENAI_ROWS rows (full width), OPENAI_QUERIES queries, M=32,
#: ef_construction=100; then fused_knn alone over 1M rows of each width
OPENAI_ROWS, OPENAI_QUERIES, OPENAI_WIDTHS = 100_000, 4096, (1536, 3072)
#: rows and queries of phase 13's fused_knn runs
OPENAI_SCAN_ROWS, OPENAI_SCAN_QUERIES = 1_000_000, 4096
#: recall@10 limits of phase 13: exact, fused (rerank 32), and the graph at
#: the first ef of bench/headline.EF_SWEEP that reaches it
OPENAI_FLOORS = {"exact": 1.0, "fused": 0.98, "graph": 0.90}


def _unit_clustered(n, d, nq, seed):
    """bench.synth.clustered rows and queries scaled to unit norm, as OpenAI's
    embeddings are (their benchmarks score them by cosine)"""
    from flatnav_tpu_torch.bench.synth import clustered

    data, queries = clustered(n, d, nq, seed=seed)
    data /= (data ** 2).sum(1, keepdims=True) ** 0.5
    queries /= (queries ** 2).sum(1, keepdims=True) ** 0.5
    return data, queries


def phase_openai():
    """Phase 13: the slice's path at OpenAI's widths. (a) The Index lifecycle
    at d = 1536, angular, with no CPU step in between: create -> add (K2 at
    every wave) -> search (K2 at every hop) over bench.headline.EF_SWEEP up
    to the first ef whose recall reaches OPENAI_FLOORS["graph"] ->
    search_exact (exact, and rerank=32: K1 "wgmma_deep", K3) -> save /
    load_index (same ids). Counts zeroed before and read after: K1 must take
    "wgmma_deep" alone, K2 must launch (every launch at d = 1536 is the
    carry-stack path). K2 is held bit-equal and timed at a recorded search
    hop, K1 within tolerance at the recorded scan. (b) fused_knn (rerank 32)
    alone over 1M unit rows of d = 1536 and 3072 with 4,096 queries: K1
    "wgmma_deep" alone, recall@10 on the first 256 queries against
    brute_force_knn held to OPENAI_FLOORS["fused"], and `_northstar.k1_times`
    at each; K2 timed at a hop of B=1024, C=512 random ids over the 1M x
    3072 table. -> dict of the phase's numbers"""
    import numpy as np
    import torch

    import flatnav_tpu_torch
    from flatnav_tpu_torch.bench._northstar import k1_times
    from flatnav_tpu_torch.bench.headline import EF_SWEEP
    from flatnav_tpu_torch.bench.measure import CallRecorder
    from flatnav_tpu_torch.index import search as search_mod
    from flatnav_tpu_torch.ops import MetricType, brute_force_knn, fused_knn
    from flatnav_tpu_torch.ops import fused_scan as fused_mod
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances

    n, d, nq, k, m, efc = OPENAI_ROWS, OPENAI_WIDTHS[0], OPENAI_QUERIES, 10, 32, 100
    data, queries = _unit_clustered(n, d, nq, seed=0x0A1)
    hop_rec = CallRecorder(gather_distances, lambda v, ids, q, mt: ids.shape[1] == 16 * m, nth=4)
    scan_rec = CallRecorder(scan_buckets)
    out = {}
    t0 = time.perf_counter()
    try:
        search_mod.gather_distances = hop_rec
        fused_mod.scan_buckets = scan_rec
        gather_distances.launches = 0
        scan_buckets.launches = 0
        scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
        _, gt = brute_force_knn(torch.from_numpy(data).cuda(), torch.from_numpy(queries).cuda(),
                                k, MetricType.IP)
        gt = gt.cpu().numpy()
        index = flatnav_tpu_torch.index.create("angular", dim=d, dataset_size=n,
                                               max_edges_per_node=m, device="cuda")
        index.add(data, ef_construction=efc)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        build_k2 = gather_distances.launches
        hop_rec.reset()  # keep a query hop, not a build hop
        graph = None
        for ef in EF_SWEEP:
            dist, lab = index.search(queries, K=k, ef_search=ef)
            check(dist.shape == (nq, k) and np.isfinite(dist).all(), f"d={d} graph output")
            r = recall(lab, gt)
            print(f"  d={d} graph ef={ef}: recall@10 {r:.4f}")
            if r >= OPENAI_FLOORS["graph"]:
                graph = {"ef": ef, "recall": r, "labels": lab, "dists": dist}
                break
        check(graph is not None, f"d={d}: the graph reaches recall {OPENAI_FLOORS['graph']} at "
              f"an ef of {EF_SWEEP}")
        for name, kw in (("exact", {}), ("fused", {"rerank": 32})):
            dist, lab = index.search_exact(queries, K=k, **kw)
            check(dist.shape == (nq, k) and np.isfinite(dist).all(), f"d={d} {name} output")
            out[name] = recall(lab, gt)
        with tempfile.TemporaryDirectory(dir=REPO) as tmp:
            path = os.path.join(tmp, "openai_index.npz")
            index.save(path)
            index2 = flatnav_tpu_torch.index.load_index(path, device="cuda")
        d2, l2 = index2.search(queries, K=k, ef_search=graph["ef"])
        torch.cuda.synchronize()
        launches = {"gather_distances": gather_distances.launches,
                    "gather_distances build": build_k2,
                    "scan_buckets": scan_buckets.launches,
                    "scan_buckets variants": dict(scan_buckets.variants)}
    finally:
        search_mod.gather_distances = gather_distances
        fused_mod.scan_buckets = scan_buckets
    out["seconds"] = time.perf_counter() - t0
    check(np.array_equal(graph["labels"], l2) and np.array_equal(graph["dists"], d2),
          f"d={d}: the reloaded index searches identically")
    variants = launches["scan_buckets variants"]
    check(variants["wgmma_deep"] > 0 and sum(variants.values()) == variants["wgmma_deep"],
          f"d={d}: K1 took wgmma_deep alone: {variants}")
    check(launches["gather_distances build"] > 0
          and launches["gather_distances"] > launches["gather_distances build"],
          f"d={d}: K2 launched in the build and in the search")
    for e in ("exact", "fused"):
        check(out[e] >= OPENAI_FLOORS[e], f"d={d}: {e} recall {out[e]} >= {OPENAI_FLOORS[e]}")
    check(hop_rec.args is not None and scan_rec.args is not None,
          f"d={d}: a search hop and a scan call were recorded")
    print(f"openai d={d} index ({out['seconds']:.1f} s, build {out['build_s']:.1f} s): N={n} "
          f"M={m} ef_construction={efc}, {nq} queries; recall@10 exact {out['exact']:.4f}, fused "
          f"{out['fused']:.4f}, graph {graph['recall']:.4f} at ef={graph['ef']}; launches "
          f"{launches}")
    k2_err = k2_against_plain(*hop_rec.args, f"d={d} hop")
    k1_err = k1_against_plain(*scan_rec.args, f"d={d} scan")
    hop = k2_timing(hop_rec.args, f"d={d} search hop")
    del index, index2, hop_rec, scan_rec
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    scans = {}
    for i, width in enumerate(OPENAI_WIDTHS):
        g = torch.Generator(device=dev).manual_seed(0x0A1 + i)
        table = torch.randn((OPENAI_SCAN_ROWS, width), device=dev, generator=g)
        table /= table.norm(dim=1, keepdim=True)
        q = torch.randn((OPENAI_SCAN_QUERIES, width), device=dev, generator=g)
        q /= q.norm(dim=1, keepdim=True)
        torch.cuda.synchronize()
        scan_buckets.launches = 0
        scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
        t1 = time.perf_counter()
        fd, fi = fused_knn(table, q, k, MetricType.IP, rerank=32)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        variants = dict(scan_buckets.variants)
        check(variants["wgmma_deep"] > 0 and sum(variants.values()) == variants["wgmma_deep"],
              f"1M x {width}: fused_knn launched K1's wgmma_deep alone: {variants}")
        check(tuple(fd.shape) == (OPENAI_SCAN_QUERIES, k) and bool(torch.isfinite(fd).all()),
              f"1M x {width}: finite distances of shape ({OPENAI_SCAN_QUERIES}, {k})")
        _, truth = brute_force_knn(table, q[:256], k, MetricType.IP)
        rec = recall(fi[:256].cpu().numpy(), truth.cpu().numpy())
        check(rec >= OPENAI_FLOORS["fused"], f"1M x {width}: fused recall@10 {rec}")
        kernel = k1_times(table, q, MetricType.IP)
        check(kernel["variant"] == "wgmma_deep", f"1M x {width}: K1 timed on wgmma_deep")
        check(kernel["max_abs_err"] <= 1e-5 * kernel["key_max"],
              f"1M x {width}: K1 within 1e-5 of its largest key of the plain version")
        k1_err = max(k1_err, kernel["max_abs_err"])
        print(f"fused_knn {OPENAI_SCAN_ROWS} x {width} unit rows, IP, {OPENAI_SCAN_QUERIES} "
              f"queries: {sec:.3f} s (first call), "
              f"recall@10 {rec:.4f}, K1 launches {variants}; K1 alone: {json.dumps(kernel)}")
        scans[width] = {"launches": variants["wgmma_deep"], "recall": rec, "seconds": sec,
                        "kernel": kernel}
        if width == OPENAI_WIDTHS[-1]:  # a hop over this table: B=1024, C=512 random ids
            hb = min(1024, q.shape[0])
            ids = torch.randint(0, OPENAI_SCAN_ROWS, (hb, 512), device=dev, generator=g,
                                dtype=torch.int32)
            call = (table, ids, q[:hb].contiguous(), MetricType.IP)
            k2_err = max(k2_err, k2_against_plain(*call, f"{width}-wide hop"))
            scans["hop_widest"] = k2_timing(call, f"{OPENAI_SCAN_ROWS} x {width} hop (random ids)")
            del ids, call
        del table, q, fd, fi, truth
        torch.cuda.empty_cache()
    return {"index": out, "graph": {"ef": graph["ef"], "recall": graph["recall"]},
            "launches": launches, "hop_1536": hop, "scans": scans, "k1_err": k1_err,
            "k2_err": k2_err}


def main() -> int:
    quick = "--quick" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "flatnav_tpu_torch")):
        print("chip_smoke: flatnav_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    t_start = last = time.perf_counter()
    phase_s = {}

    def mark(name):
        nonlocal last
        now = time.perf_counter()
        phase_s[name] = round(now - last, 1)
        last = now

    phase_build()
    mark("1 build")
    rng = np.random.default_rng(0xF1A7)
    k2_err, k1_err = phase_kernels(rng)
    k3_err = phase_k3()
    mark("2 kernels")
    k1 = {"name": "scan_buckets", "route": "cuda", "variant": "wgmma",
          "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
          "replaces": "flatnav_tpu/ops/fused_scan.py:159"}
    k2 = {"name": "gather_distances", "route": "cuda", "variant": "registers",
          "source": "flatnav_tpu_torch/csrc/gather_distance.cu",
          "replaces": "flatnav_tpu/ops/gather_distance.py:54"}
    k1p = {"name": "profile_fused_stages phaseA", "route": "cuda", "variant": "wgmma",
           "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
           "replaces": "tools/profile_fused_stages.py:70"}
    # K3's two routes, each timed at a call of its own: the block route
    # (bulk copies into a ring, filter, radix select) at 1M phase B, the
    # warp route (a warp a row, its list sorted in registers) at a build
    # selection of the main path
    k3 = {"name": "select_k", "route": "cuda", "variant": "block",
          "source": "flatnav_tpu_torch/csrc/select_k.cu",
          "replaces": "flatnav_tpu/ops/fused_scan.py:385"}
    k3w = {"name": "select_k warp", "route": "cuda", "variant": "warp",
           "source": "flatnav_tpu_torch/csrc/select_k.cu",
           "replaces": "flatnav_tpu/ops/fused_scan.py:385"}
    kernels = [k1, k2, k3, k3w]
    if not quick:
        launches, hop, wave, build_sel, k1_main, k2_main, k3_main, path = phase_main_path()
        k2.update(k2_timing(hop, "main-path search hop"))
        k2["build_wave"] = k2_timing(wave, "main-path build wave")
        intra, lane_ids, c2 = build_sel
        k3w.update(k3_times(intra, c2, lane_ids, "row", "a main-path build selection"))
        del build_sel, intra, lane_ids
        mark("3 main path")
        beam = phase_beam_hop(path)
        timed_at = beam["cases"][0]
        kernels.append({
            "name": "beam_hop", "route": "cuda", "variant": "select+membership+merge",
            "source": "flatnav_tpu_torch/csrc/beam_hop.cu",
            "replaces": "flatnav_tpu/index/search.py:514",
            "launches": launches["beam_hop"], "launches_by_step": launches["beam_hop by step"],
            "max_abs_err": 0.0, "hops_checked": beam["hops checked"],
            "ms": timed_at["kernels_ms"], "plain_ms": timed_at["chain_ms"],
            "bound_ms": timed_at["bound_ms"], "bound_by": timed_at["bound_by"],
            "library_ms": None,
            "timed_at": {x: timed_at[x] for x in ("case", "b", "ef", "e", "m", "hist")},
            "cases": beam["cases"],
        })
        mark("3b beam hop")
        k2["launches_reordered_search"] = phase_reorder(path)
        mark("5 reorder")
        phase_pq_graph(path)
        mark("6a pq graph")
        k1["launches_harness"], k2["launches_harness"] = phase_harness(path)
        mark("7 harness")
        sharded, k1_shard, k2_shard = phase_sharded(path)
        mark("10 parallel")
        k1["launches_sharded"] = sharded["scan_buckets"]
        k2["launches_sharded"] = sharded["gather_distances"]
        del path
        head, k2_compact = phase_headline()
        mark("8 headline")
        k1["launches_headline"] = head["kernel_launches"]["scan_buckets"]
        k2["launches_headline"] = head["kernel_launches"]["gather_distances"]
        phase_routed_scan()
        mark("9 routed scan")
        err_1m, k1_times, k1p_times, k3_times_1m, table = phase_scan_1m()
        mark("4 1M scan")
        k2["launches_pq_raw_rerank"] = phase_pq_scan(table)
        del table
        mark("6b pq scan")
        north = phase_northstar()
        mark("11 north star")
        new = phase_new_shapes()
        mark("12 spacev and glove")
        openai = phase_openai()
        mark("13 openai")
        deep = openai["scans"][1536]["kernel"]
        kernels.append({
            "name": "scan_buckets wgmma_deep", "route": "cuda", "variant": "wgmma_deep",
            "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
            "replaces": "flatnav_tpu/ops/fused_scan.py:159",
            "launches": openai["launches"]["scan_buckets variants"]["wgmma_deep"],
            "launches_by_run": {"index d=1536": openai["launches"]["scan_buckets"],
                                **{f"fused_knn 1M x {w}": openai["scans"][w]["launches"]
                                   for w in OPENAI_WIDTHS}},
            "max_abs_err": openai["k1_err"],
            **{x: deep[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": deep["matmul_bf16_ms"], "library": "torch.matmul bf16",
            "timed_at": {x: deep[x] for x in ("qc", "n", "d", "rows", "queries", "L", "T")},
            "shapes": {w: openai["scans"][w]["kernel"] for w in OPENAI_WIDTHS},
        })
        kernels.append({
            "name": "gather_distances carry stack", "route": "cuda", "variant": "carry stack",
            "source": "flatnav_tpu_torch/csrc/gather_distance.cu",
            "replaces": "flatnav_tpu/ops/gather_distance.py:54",
            "launches": openai["launches"]["gather_distances"],
            "launches_build": openai["launches"]["gather_distances build"],
            "max_abs_err": openai["k2_err"], **openai["hop_1536"],
            "timed_at": "a search hop of the d=1536 index",
            f"hop_{OPENAI_WIDTHS[-1]}": openai["scans"]["hop_widest"],
        })
        for variant in ("wgmma_int8_packed", "wgmma_narrow", "wgmma_mixed"):
            runs = {r: v for r, v in new.items() if v["variant"] == variant}
            timed_in = next(iter(runs.values()))["kernel"]
            kernels.append({
                "name": f"scan_buckets {variant}", "route": "cuda", "variant": variant,
                "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
                "replaces": "flatnav_tpu/ops/fused_scan.py:159",
                "launches": sum(v["launches"] for v in runs.values()),
                "launches_by_run": {r: v["launches"] for r, v in runs.items()},
                "max_abs_err": max(v["kernel"]["max_abs_err"] for v in runs.values()),
                **{x: timed_in[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": timed_in["int_mm_ms"] or timed_in["matmul_bf16_ms"],
                "library": "torch._int_mm" if timed_in["int_mm_ms"] else "torch.matmul bf16",
                "matmul_bf16_ms": timed_in["matmul_bf16_ms"],
                "timed_at": {x: timed_in[x] for x in ("qc", "n", "d", "rows", "queries", "L", "T")},
                "ids_equal": timed_in["ids_equal"],
                # the kernel this variant replaced at these operands
                **{f"{v}_ms": ms for v, ms in timed_in["also_ms"].items()},
            })
        k1["launches_glove_50"] = new["glove-50"]["launches"]
        k1["glove_50"] = new["glove-50"]["kernel"]
        for variant, run_names in (("wgmma_wide", ("gist",)),
                                   ("wgmma_int8", ("bigann 10M", "bigann 100M"))):
            timed_in = north[run_names[-1]]["kernels"]["scan_buckets"]
            kernels.append({
                "name": f"scan_buckets {variant}", "route": "cuda", "variant": variant,
                "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
                "replaces": "flatnav_tpu/ops/fused_scan.py:159",
                "launches": sum(north[r]["launches"]["scan_buckets variants"][variant]
                                for r in run_names),
                "launches_by_run": {r: north[r]["launches"]["scan_buckets variants"][variant]
                                    for r in run_names},
                "max_abs_err": max(north[r]["kernels"]["scan_buckets"]["max_abs_err"]
                                   for r in run_names),
                **{x: timed_in[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": timed_in["int_mm_ms"] or timed_in["matmul_bf16_ms"],
                "library": "torch._int_mm" if timed_in["int_mm_ms"] else "torch.matmul bf16",
                "matmul_bf16_ms": timed_in["matmul_bf16_ms"],
                "timed_at": {x: timed_in[x] for x in ("qc", "n", "d", "rows", "queries", "L", "T")},
                "shapes": {r: north[r]["kernels"]["scan_buckets"] for r in run_names},
            })
        k1["launches_northstar_angular"] = north["angular"]["launches"]["scan_buckets variants"]["wgmma"]
        k1["northstar_angular"] = north["angular"]["kernels"]["scan_buckets"]
        k2["launches_northstar"] = {r: v["launches"]["gather_distances"] for r, v in north.items()}
        k2["northstar_hops"] = {r: v["kernels"]["gather_distances"] for r, v in north.items()
                                if v["kernels"].get("gather_distances")}
        k1.update(k1_times)
        k1p.update(k1p_times, max_abs_err=err_1m)
        kernels.append(k1p)
        k1["launches"] = launches["scan_buckets"]
        k2["launches"] = launches["gather_distances"]
        by_route = launches["select_k by route"]
        k3.update(k3_times_1m, launches=by_route["block"], launches_all_routes=launches["select_k"],
                  launches_by_step=launches["select_k by step"], launches_by_route=by_route,
                  launches_by_step_and_route=launches["select_k by step and route"])
        k3w["launches"] = by_route["warp"]
        k3_err = max(k3_err, k3_main)
        k1_err = max(k1_err, k1_main, err_1m, k1_shard)
        k2_err = max(k2_err, k2_main, k2_compact, k2_shard)
    k1["max_abs_err"], k2["max_abs_err"] = k1_err, k2_err
    k3["max_abs_err"] = k3w["max_abs_err"] = k3_err
    print(f"seconds by phase: {phase_s}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
