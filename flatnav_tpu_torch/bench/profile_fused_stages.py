"""Stage-level timing of the fused scan engine (`fused_knn`) on the card.

    python -m flatnav_tpu_torch.bench.profile_fused_stages [--n 1000000] [--d 128]
        [--b 4096] [--k 10] [--rerank 32] [--l 16] [--tile 2048] [--reps 4]

Counterpart of tools/profile_fused_stages.py. At one (N x d, B) shape it
times each suffix of the pipeline, so the differences between rows
attribute the engine's time:

  matmul     torch.matmul bf16 per row tile with an amin over the columns: a
             yardstick for any whole-table scan at this shape, never on the
             path
  phaseA     scan_buckets (kernel K1) at the shapes `_pick_shapes` gives, on
             K1's own grid: the [B, N/L] bucket minima and ids
  phaseAB    phaseA + the exact top-`rerank` shortlist (`smallest_k`: kernel
             K3 on the card, ids read)
  norerank   fused_knn(exact_rerank=False): phaseAB + ranking by the keys
  full       fused_knn(exact_rerank=True): + the row gather and exact rescore
  gather     the rerank's row gather + rescore + stable argsort alone, on
             random ids

Each stage is timed with CUDA events over `--reps` calls after one warm-up
call, and printed with its TFLOP/s (2 B N d operations; not for `gather`) and
its share of the H100's 989 TFLOP/s bf16 dense peak, under the card's name
and power limit.
The stages are plain functions of tensors (`stages`), so they also run on
CPU tensors; `main()` needs a CUDA card and returns 2 without one. The data
is i.i.d. normal float32 from `numpy.random.default_rng(0)`, as in the JAX
tool.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from flatnav_tpu_torch.bench.measure import BF16_FLOP_PER_S, card, timed
from flatnav_tpu_torch.ops.distances import (
    MetricType,
    query_block_distances,
    smallest_k,
    squared_norms,
)
from flatnav_tpu_torch.ops.fused_scan import (
    _QB,
    _SUMMARY_BYTES,
    _TILE,
    _pick_shapes,
    _tile_request,
    fused_knn,
    scan_buckets,
)

PEAK_BF16_TFLOPS = BF16_FLOP_PER_S / 1e12
STAGE_NAMES = ("matmul", "phaseA", "phaseAB", "norerank", "full", "gather")


def stages(vecs: torch.Tensor, q: torch.Tensor, k: int = 10, rerank: int = 32,
           l: int | None = 16, tile: int = _TILE, seed: int = 0):
    """-> ({stage name: zero-argument callable}, (L, T, qc)).

    vecs [N, d] float32, q [B, d] float32, on any one device. The scan
    stages take the shapes `fused_knn(bucket_l=l, tile_size=tile)` takes;
    `gather` scores `max(rerank, k)` random ids per query (drawn from
    `seed`)."""
    n, d = vecs.shape
    b = q.shape[0]
    r = max(rerank, k)
    L, t, _, qc = _pick_shapes(n, b, d, 2, _tile_request(tile, l), _QB, l, _SUMMARY_BYTES)
    ds_bf = vecs.to(torch.bfloat16)
    q_bf = q.to(torch.bfloat16)
    pen = squared_norms(ds_bf)
    cand = torch.from_numpy(
        np.random.default_rng(seed).integers(0, n, (b, r)).astype(np.int32)
    ).to(vecs.device)

    def matmul():
        best = None
        for r0 in range(0, n, t):
            m = torch.matmul(q_bf, ds_bf[r0 : r0 + t].T).amin(dim=1)
            best = m if best is None else torch.minimum(best, m)
        return best

    def phase_a():
        return [scan_buckets(q_bf[lo : lo + qc], ds_bf, pen, n, t, L)
                for lo in range(0, b, qc)]

    def phase_ab():
        short = [smallest_k(bmin, bids, min(r, bmin.shape[1])) for bmin, bids in phase_a()]
        return torch.cat([s[0] for s in short]), torch.cat([s[1] for s in short])

    def knn(exact):
        return lambda: fused_knn(vecs, q, k, MetricType.L2, rerank=rerank, bucket_l=l,
                                 tile_size=tile, exact_rerank=exact)

    def gather():
        ex = query_block_distances(q, vecs[cand.long()], MetricType.L2)
        order = torch.argsort(ex, dim=1, stable=True)[:, :k]
        return ex.gather(1, order), cand.gather(1, order)

    fns = dict(matmul=matmul, phaseA=phase_a, phaseAB=phase_ab,
               norerank=knn(False), full=knn(True), gather=gather)
    return fns, (L, t, qc)


def time_stages(fns, flops: float, reps: int) -> dict[str, float]:
    """Mean ms per call of each stage by CUDA events, one warm-up call
    first; prints one line per stage."""
    out = {}
    for name in STAGE_NAMES:
        ms = timed(fns[name], reps, warmup=1)
        if name == "gather":  # does none of the scan's products
            print(f"{name:>9}: {ms:9.3f} ms", flush=True)
        else:
            tf = flops / (ms * 1e-3) / 1e12
            print(f"{name:>9}: {ms:9.3f} ms  {tf:7.1f} TFLOP/s  "
                  f"{100 * tf / PEAK_BF16_TFLOPS:5.1f}% of {PEAK_BF16_TFLOPS:.0f}", flush=True)
        out[name] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--b", type=int, default=4096)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rerank", type=int, default=32)
    ap.add_argument("--l", type=int, default=16)
    ap.add_argument("--tile", type=int, default=_TILE)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fused_stages: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    vecs = torch.from_numpy(rng.standard_normal((args.n, args.d), dtype=np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((args.b, args.d), dtype=np.float32)).cuda()
    fns, (L, t, qc) = stages(vecs, q, args.k, args.rerank, args.l, args.tile)
    flops = 2.0 * args.b * args.n * args.d
    print(f"{card()}; N={args.n} d={args.d} B={args.b} k={args.k} rerank={args.rerank} "
          f"L={L} T={t} query chunk={qc}; scan {flops / 1e12:.3f} TFLOP", flush=True)
    time_stages(fns, flops, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
