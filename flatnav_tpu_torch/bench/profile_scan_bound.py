"""Stage split of the port's table scans, `brute_force_knn` and `fast_knn`,
against the matmul alone.

    python -m flatnav_tpu_torch.bench.profile_scan_bound [--n 1000000] [--d 128]
        [--b 4096] [--k 10] [--tile 262144] [--rerank 32] [--reps 4]
        [--sweep] [--tiles T ...] [--reranks R ...] [--batches B ...]
        [--device cpu]

Counterpart of tools/profile_scan_bound.py and, under `--sweep`, of
tools/profile_exact.py. At one (N x d table, B queries) shape, over the same
row tiles, it times:

  matmul   one bf16 product a tile (float32 result) and a running minimum:
           the scan's products with no selection, the yardstick of the bound
  select   matmul + the port's exact selection as fast_knn takes it: the
           `rerank` smallest of each tile's keys (implicit ids) and the
           running shortlist, one K3 launch a tile seeded with it:
           fast_knn's phase 1 without its norms and rerank. It stands where
           the JAX tool's `approx` stage (approx_min_k a tile) stood; the
           port's top-k is exact
  fastknn  `fast_knn` whole (bf16 keys, exact shortlist, exact rerank)
  exact    `brute_force_knn` whole (float32 products, top-k a tile)

`select` - `matmul` is what the selection costs, `fastknn` - `select` the
norms and the rerank. With `--sweep` it then times `brute_force_knn` at each
of `--tiles` and `fast_knn` at each tile and `--reranks` width, for each of
`--batches` query counts (profile_exact.py's sweeps).

On the card every stage is timed by CUDA events (`measure.timed`: one
warm-up call, then the mean of `--reps`); on the CPU by the host clock around
the same calls. Each line gives ms, TFLOP/s (2 B N d operations) and its share
of the H100's dense bf16 peak (`measure.BF16_FLOP_PER_S`). The table is
i.i.d. normal float32 from `numpy.random.default_rng(0)`, padded to whole
tiles as in the JAX tool; the last line is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from flatnav_tpu_torch.bench.measure import BF16_FLOP_PER_S, timed
from flatnav_tpu_torch.bench._northstar import device_line
from flatnav_tpu_torch.data_type import resolve_device
from flatnav_tpu_torch.ops.distances import (
    MetricType,
    bf16_dot,
    brute_force_knn,
    _merge_tile,
    fast_knn,
)

STAGE_NAMES = ("matmul", "select", "fastknn", "exact")


def stages(vecs: torch.Tensor, q: torch.Tensor, n: int, k: int = 10, tile: int = 262144,
           rerank: int = 32):
    """{stage name: zero-argument callable} over the first `n` rows of
    `vecs` (a whole number of `tile`-row tiles, float32) and queries `q`
    (float32), on one device."""
    n_tiles = vecs.shape[0] // tile
    vecs_bf, q_bf = vecs.to(torch.bfloat16), q.to(torch.bfloat16)
    b = q.shape[0]

    def product(i):
        return bf16_dot(q_bf, vecs_bf[i * tile : (i + 1) * tile])

    def matmul():
        best = torch.full((b,), float("inf"), device=vecs.device)
        for i in range(n_tiles):
            best = torch.minimum(best, product(i).amin(dim=1))
        return best

    def select():
        best_k = torch.full((b, rerank), float("inf"), device=vecs.device)
        best_i = torch.zeros((b, rerank), dtype=torch.int32, device=vecs.device)
        for i in range(n_tiles):
            best_k, best_i = _merge_tile(best_k, best_i, product(i), i * tile, (0, tile))
        return best_k

    return {
        "matmul": matmul,
        "select": select,
        "fastknn": lambda: fast_knn(vecs, q, k, MetricType.L2, tile_size=tile, rerank=rerank,
                                    n_valid=n)[1],
        "exact": lambda: brute_force_knn(vecs, q, k, MetricType.L2, n_valid=n)[1],
    }


def time_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms a call after one warm-up: CUDA events on the card, the host
    clock on the CPU."""
    if dev.type == "cuda":
        return timed(fn, reps, warmup=1)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _line(label: str, ms: float, flops: float, b: int) -> dict:
    tf = flops / (ms * 1e-3) / 1e12
    share = tf / (BF16_FLOP_PER_S / 1e12)
    print(f"{label:>28}: {ms:10.3f} ms  {tf:8.2f} TFLOP/s  {100 * share:5.1f}% of bf16 peak  "
          f"{b / (ms * 1e-3):10.0f} qps", flush=True)
    return {"ms": ms, "tflops": tf, "peak_share": share}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tile", type=int, default=262144)
    ap.add_argument("--rerank", type=int, default=32)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep tiles, rerank widths and batches (profile_exact.py)")
    ap.add_argument("--tiles", type=int, nargs="+", default=[32768, 65536, 131072, 262144])
    ap.add_argument("--reranks", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--batches", type=int, nargs="+", default=None,
                    help="query counts of the sweep (default: --b)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n, d, b, tile = args.n, args.d, args.b, min(args.tile, args.n)
    n_tiles = -(-n // tile)
    rng = np.random.default_rng(0)
    vecs = torch.from_numpy(rng.standard_normal((n_tiles * tile, d), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    flops = 2.0 * n_tiles * tile * b * d
    device = device_line(dev)
    print(f"{device}; N={n} d={d} B={b} tile={tile} rerank={args.rerank}; scan "
          f"{flops / 1e12:.3f} TFLOP", flush=True)
    fns = stages(vecs, q, n, args.k, tile, args.rerank)
    out = {"device": device, "n": n, "d": d, "b": b, "tile": tile, "rerank": args.rerank,
           "stages": {name: _line(name, time_ms(fns[name], args.reps, dev), flops, b)
                      for name in STAGE_NAMES}}
    if args.sweep:
        rows = []
        for bs in args.batches or [b]:
            qs = q[:bs] if bs <= b else torch.from_numpy(
                rng.standard_normal((bs, d), dtype=np.float32)).to(dev)
            fl = 2.0 * n * bs * d
            for t in args.tiles:
                if t > n:
                    continue
                ms = time_ms(lambda: brute_force_knn(vecs[:n], qs, args.k, tile_size=t),
                             args.reps, dev)
                rows.append({"engine": "exact", "b": bs, "tile": t,
                             **_line(f"exact B={bs} tile={t}", ms, fl, bs)})
                for r in args.reranks:
                    ms = time_ms(lambda: fast_knn(vecs[:n], qs, args.k, tile_size=t, rerank=r),
                                 args.reps, dev)
                    rows.append({"engine": "fast", "b": bs, "tile": t, "rerank": r,
                                 **_line(f"fast B={bs} tile={t} rerank={r}", ms, fl, bs)})
        out["sweep"] = rows
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
