#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (flatnav_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-2 only (build + kernel checks)

Phases, in order; any failure raises and the script exits nonzero:

  1. environment and build: the card's name and power limit (nvidia-smi),
     torch and CUDA versions, and every kernel under
     flatnav_tpu_torch/csrc built by nvcc (in parallel) with its seconds.
  2. each kernel against its plain PyTorch version, on the card:
     K2 gather_distances bit-equal (torch.equal) at d in {7, 37, 128, 960},
     L2/IP, f32/bf16/f16 tables, ragged B x C; K1 scan_buckets bit-equal on
     uint8/int8 tables and within 1e-5 of the key magnitude on bf16 tables
     (ids equal wherever a bucket's best two keys differ by more), at
     d in {37, 64, 128, 256}, L2/IP, N not a multiple of the tile and
     n_valid < N; bf16 at d in {64, 128, 256} takes K1's "wgmma" variant,
     the rest its "mma" variant (the wrapper picks by shape).
  3. the main path at full width, the README configuration: clustered data
     (seed 0x5EED), N=100,000, d=128 float32, L2, M=32, ef_construction=100,
     4,096 queries, K=10: create -> add -> search(ef_search=192) ->
     search_exact(rerank=0 / 32 / 32 without exact rerank) -> save ->
     load_index -> search (must be identical). Kernel launch counters are
     zeroed just before and read just after; recall@10 of every engine is
     measured against the port's brute_force_knn. Each kernel is then held
     against its plain version on the arguments the path gave it (a search
     hop and a build wave of B=8192, C=1024 for K2, the first scan of
     search_exact for K1), and K2 is timed at both.
  4. the scan at SIFT1M scale: search_exact(rerank=32) and fused_knn over a
     1M x 128 float32 clustered table with B=4096, with recall and K1 time;
     then the stage profiler's stages (bench/profile_fused_stages.py:
     matmul, phaseA = K1', phaseAB, norerank, full, gather) on the same
     table, with K1's launches counted over them.

The line before the last is one JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
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
    """Run K1 and its plain version on the same inputs; 8-bit tables must be
    bit-equal, bf16 minima within 1e-5 of the largest key magnitude (the
    sums run in another order) with ids equal wherever a bucket's best two
    keys differ by more than twice that. Returns the max abs error."""
    import torch

    from flatnav_tpu_torch.ops.fused_scan import scan_buckets, scan_buckets_plain

    kmin, kid = scan_buckets(q, rows, pen, nlim, t, L)
    pmin, pid = scan_buckets_plain(q, rows, pen, nlim, t, L)
    torch.cuda.synchronize()
    fin = torch.isfinite(pmin)
    check(torch.equal(fin, torch.isfinite(kmin)), f"K1 inf mask {tag}")
    err = float((kmin[fin] - pmin[fin]).abs().max()) if bool(fin.any()) else 0.0
    if rows.dtype != torch.bfloat16:
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


def phase_kernels(rng):
    """-> (K2 max abs error, K1 max abs error)"""
    import torch

    from flatnav_tpu_torch.ops import MetricType
    from flatnav_tpu_torch.ops.distances import squared_norms
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets

    dev = torch.device("cuda")
    k2_err = 0.0
    for d in (7, 37, 128, 960):
        for metric in (MetricType.L2, MetricType.IP):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                n, b, c = 5000, 37, 129  # ragged B x C
                vec = torch.from_numpy(rng.standard_normal((n, d), dtype="float32")).to(dev, dtype)
                ids = torch.from_numpy(rng.integers(0, n, (b, c)).astype("int32")).to(dev)
                q = torch.from_numpy(rng.standard_normal((b, d), dtype="float32")).to(dev)
                k2_err = max(k2_err, k2_against_plain(
                    vec, ids, q, metric, f"d={d} {metric.value} {dtype}"))
    print("K2 gather_distances: bit-equal to the plain version on 24 cases")

    k1_err = 0.0
    t, L = 2048, 16
    for d in (37, 64, 128, 256):
        for metric in (MetricType.L2, MetricType.IP):
            for dtype in (torch.uint8, torch.int8, torch.bfloat16):
                n, nlim, qc = 10000, 9000, 100  # n not a multiple of t
                if dtype == torch.bfloat16:
                    rows = torch.from_numpy(rng.standard_normal((n, d), dtype="float32")).to(dev, dtype)
                    q = torch.from_numpy(rng.standard_normal((qc, d), dtype="float32")).to(dev, dtype)
                else:
                    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
                    rows = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype("int16")).to(dev, dtype)
                    q = torch.from_numpy(rng.integers(lo, hi, (qc, d)).astype("int16")).to(dev).to(torch.bfloat16)
                pen = (squared_norms(rows) if metric == MetricType.L2
                       else torch.zeros(n, device=dev))
                k1_err = max(k1_err, k1_against_plain(
                    q, rows, pen, nlim, t, L, f"d={d} {metric.value} {dtype}"))
    print(f"K1 scan_buckets: 8-bit bit-equal, bf16 max abs err {k1_err:g} on 24 cases; "
          f"launches by variant {scan_buckets.variants}")
    return k2_err, k1_err


class CallRecorder:
    """Stands in for a kernel wrapper where a module calls it and keeps the
    arguments of the `nth` call that `keep(*args)` accepts since the last
    reset; the wrapper it calls counts its own launches."""

    def __init__(self, fn, keep=lambda *args: True, nth=1):
        self.fn, self.keep, self.nth = fn, keep, nth
        self.reset()

    def reset(self):
        self.seen, self.args = 0, None

    # the wrapper counts its launches through its module's name, which
    # names this recorder while it stands in
    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __getattr__(self, name):  # the wrapper's other counters
        if name == "fn":
            raise AttributeError(name)
        return getattr(self.fn, name)

    def __call__(self, *args):
        if self.keep(*args):
            self.seen += 1
            if self.seen == self.nth:
                self.args = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        return self.fn(*args)


def phase_main_path():
    import numpy as np
    import torch

    import flatnav_tpu_torch
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.index import search as search_mod
    from flatnav_tpu_torch.ops import brute_force_knn
    from flatnav_tpu_torch.ops import fused_scan as fused_mod
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances

    n, d, m, efc, nq, k, ef = 100_000, 128, 32, 100, 4096, 10, 192
    data, queries = clustered(n, d, nq, seed=0x5EED)
    _, gt = brute_force_knn(torch.from_numpy(data).cuda(), torch.from_numpy(queries).cuda(), k)
    gt = gt.cpu().numpy()
    # keep the 88th build-wave call (B=8192, C=1024; about half of the
    # build's, in its 7th wave: the first waves score a nearly empty graph),
    # the 4th full-width hop of the graph search (its first hops start from
    # the few entry points and repeat rows far more than a typical hop) and
    # the first K1 call of search_exact
    wave_rec = CallRecorder(gather_distances, lambda v, ids, q, mt: tuple(ids.shape) == (8192, 1024),
                            nth=88)
    hop_rec = CallRecorder(wave_rec, lambda v, ids, q, mt: ids.shape[1] == 16 * m, nth=4)
    scan_rec = CallRecorder(scan_buckets)
    search_mod.gather_distances = hop_rec
    fused_mod.scan_buckets = scan_rec
    out = {}
    try:
        gather_distances.launches = 0
        scan_buckets.launches = 0
        scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = flatnav_tpu_torch.index.create(
            "l2", dim=d, dataset_size=n, max_edges_per_node=m, device="cuda"
        )
        index.add(data, ef_construction=efc)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        hop_rec.reset()  # keep a query hop, not a build hop

        def run(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dist, lab = fn()
            sec = time.perf_counter() - t
            check(dist.shape == (nq, k) and np.isfinite(dist).all(), f"{name} output")
            out[name] = {"recall": recall(lab, gt), "qps": nq / sec, "s": sec}
            return dist, lab

        d1, l1 = run("graph", lambda: index.search(queries, K=k, ef_search=ef))
        run("exact", lambda: index.search_exact(queries, K=k))
        run("fused", lambda: index.search_exact(queries, K=k, rerank=32))
        run("fusednr", lambda: index.search_exact(queries, K=k, rerank=32, exact_rerank=False))
        with tempfile.TemporaryDirectory(dir=REPO) as tmp:
            path = os.path.join(tmp, "smoke_index.npz")
            index.save(path)
            index2 = flatnav_tpu_torch.index.load_index(path, device="cuda")
        d2, l2 = index2.search(queries, K=k, ef_search=ef)
        torch.cuda.synchronize()
        launches = {"gather_distances": gather_distances.launches,
                    "scan_buckets": scan_buckets.launches,
                    "scan_buckets variants": dict(scan_buckets.variants)}
    finally:
        search_mod.gather_distances = gather_distances
        fused_mod.scan_buckets = scan_buckets
    check(np.array_equal(l1, l2) and np.array_equal(d1, d2), "reloaded search identical")
    print(f"main path: N={n} d={d} M={m} ef_construction={efc} build {out['build_s']:.2f} s")
    for name in ("graph", "exact", "fused", "fusednr"):
        r = out[name]
        print(f"  {name}: recall@10 {r['recall']:.4f}  qps {r['qps']:.1f}  ({r['s']:.3f} s)")
    print(f"  launches on the main path: {launches}")
    check(launches["gather_distances"] > 0 and launches["scan_buckets"] > 0, "kernel launches")
    check(launches["scan_buckets variants"]["mma"] == 0, "the main path's K1 takes the wgmma variant")
    check(out["exact"]["recall"] == 1.0, "exact recall == 1.0")
    check(out["fused"]["recall"] >= 0.98, "fused recall >= 0.98")
    check(out["graph"]["recall"] >= 0.90, "graph recall >= 0.90")
    check(hop_rec.args is not None and wave_rec.args is not None and scan_rec.args is not None,
          "a search hop, a build wave and a scan call were recorded")
    # each kernel against its plain version at the shapes the path gave it
    k2_err = k2_against_plain(*hop_rec.args, "main-path hop")
    k2_err = max(k2_err, k2_against_plain(*wave_rec.args, "main-path build wave"))
    q_bf, rows, pen, nlim, t, L = scan_rec.args
    k1_err = k1_against_plain(*scan_rec.args, "main-path scan")
    print(f"  at the main path's shapes: K2 B x C = {tuple(hop_rec.args[1].shape)} and "
          f"{tuple(wave_rec.args[1].shape)} bit-equal; "
          f"K1 q {tuple(q_bf.shape)} rows {tuple(rows.shape)} {rows.dtype} T={t} L={L} "
          f"max abs err {k1_err:g}")
    return launches, hop_rec.args, wave_rec.args, k1_err, k2_err


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
    print(f"K2 at a main-path {what} B={b} C={c} d={d} ({uniq} distinct rows): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, distinct-row bound {bound:.4f} ms ({by}); "
          f"gathered {gathered / 1e6:.1f} MB at {gathered / (ms * 1e-3) / 1e12:.2f} TB/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


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

    # the stage profiler (K1') on the same table: its phaseA is K1 at these
    # shapes, launched through the tool's own stage functions
    fns, _ = pfs.stages(ds, q, k=10, rerank=32, l=L, tile=t)
    print(f"stage profiler at N={n} d={d} B={b} L={L} T={t} ({card()})")
    scan_buckets.launches = 0
    scan_buckets.variants = dict.fromkeys(scan_buckets.variants, 0)
    stage_ms = pfs.time_stages(fns, 2.0 * b * n * d, reps=2)
    torch.cuda.synchronize()
    stage_launches = scan_buckets.launches
    check(stage_launches > 0 and scan_buckets.variants["mma"] == 0,
          "the stage profiler launched K1's wgmma variant")
    k1p = {"ms": stage_ms["phaseA"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": stage_ms["matmul"], "launches": stage_launches}
    return err, k1, k1p


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

    t_start = time.perf_counter()
    phase_build()
    rng = np.random.default_rng(0xF1A7)
    k2_err, k1_err = phase_kernels(rng)
    k1 = {"name": "scan_buckets", "route": "cuda", "variant": "wgmma",
          "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
          "replaces": "flatnav_tpu/ops/fused_scan.py:159"}
    k2 = {"name": "gather_distances", "route": "cuda", "variant": "registers",
          "source": "flatnav_tpu_torch/csrc/gather_distance.cu",
          "replaces": "flatnav_tpu/ops/gather_distance.py:54"}
    k1p = {"name": "profile_fused_stages phaseA", "route": "cuda", "variant": "wgmma",
           "source": "flatnav_tpu_torch/csrc/fused_scan.cu",
           "replaces": "tools/profile_fused_stages.py:70"}
    kernels = [k1, k2]
    if not quick:
        launches, hop, wave, k1_main, k2_main = phase_main_path()
        k2.update(k2_timing(hop, "search hop"))
        k2["build_wave"] = k2_timing(wave, "build wave")
        err_1m, k1_times, k1p_times = phase_scan_1m()
        k1.update(k1_times)
        k1p.update(k1p_times, max_abs_err=err_1m)
        kernels.append(k1p)
        k1["launches"] = launches["scan_buckets"]
        k2["launches"] = launches["gather_distances"]
        k1_err = max(k1_err, k1_main, err_1m)
        k2_err = max(k2_err, k2_main)
    k1["max_abs_err"], k2["max_abs_err"] = k1_err, k2_err
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
