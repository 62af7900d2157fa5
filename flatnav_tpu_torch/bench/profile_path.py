"""Where the main path's time goes on the card: torch.profiler over the
graph build, the graph search and the fused scan of the README
configuration (clustered data, seed 0x5EED, d=128, L2, M=32,
ef_construction=100, ef_search=192, K=10).

    python -m flatnav_tpu_torch.bench.profile_path [--n 100000] [--queries 4096]

For each stage it prints the wall time without the profiler, the wall time
and the summed device time under it (device busy share = device time /
profiled wall; kernels run on one stream, so they do not overlap), the
number of kernel launches, and the kernels that take the most device time.
Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

import flatnav_tpu_torch
from flatnav_tpu_torch.bench.synth import clustered


def _device_us(evt) -> float:
    """Device time of a kernel's entry; 0 for a host op (whose device time
    would count its kernels a second time)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(getattr(evt, "self_device_time_total", 0)
                 or getattr(evt, "self_cuda_time_total", 0))


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_stage(label: str, fn, top: int = 10) -> None:
    fn()  # warm: kernel libraries loaded, allocator and library handles set up
    plain_s = _wall(fn)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_s = _wall(fn)
    evts = prof.key_averages()
    kernels = sorted(((_device_us(e), e.count, e.key) for e in evts if _device_us(e) > 0),
                     reverse=True)
    busy_us = sum(k[0] for k in kernels)
    launches = sum(e.count for e in evts if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    print(f"{label}: wall {plain_s * 1e3:.3f} ms unprofiled, {prof_s * 1e3:.3f} ms profiled; "
          f"device {busy_us / 1e3:.3f} ms busy ({100 * busy_us / (prof_s * 1e6):.1f}% of the "
          f"profiled wall); {launches} kernel launches")
    for us, count, key in kernels[:top]:
        print(f"  {us / 1e3:10.3f} ms {100 * us / busy_us:5.1f}% x{count:<7d} {key[:110]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--queries", type=int, default=4096)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_path: no CUDA device", file=sys.stderr)
        return 2
    d, m, efc, ef, k = 128, 32, 100, 192, 10
    data, queries = clustered(args.n, d, args.queries, seed=0x5EED)
    print(f"{torch.cuda.get_device_name(0)}; N={args.n} d={d} M={m} "
          f"ef_construction={efc} queries={args.queries} ef_search={ef} K={k}")

    def build():
        ix = flatnav_tpu_torch.index.create("l2", dim=d, dataset_size=args.n,
                                            max_edges_per_node=m)
        ix.add(data, ef_construction=efc)
        return ix

    index = build()
    profile_stage("build", build)
    profile_stage("search", lambda: index.search(queries, K=k, ef_search=ef))
    profile_stage("search_exact(rerank=32)",
                  lambda: index.search_exact(queries, K=k, rerank=32))
    return 0


if __name__ == "__main__":
    sys.exit(main())
