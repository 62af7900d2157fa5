"""Synthetic benchmark datasets (numpy only).

A copy of flatnav_tpu/bench/synth.py, kept here so that the port imports
nothing of the JAX package; the same seed gives the same arrays in both.

`clustered` is a Gaussian-mixture stand-in for SIFT1M-class workloads:
real embedding datasets are clustered, and recall behaviour (hubs, local
connectivity) differs materially from i.i.d. gaussian data. Parameters
are tuned so that recall@10 at M=32 reaches ~0.95 around ef_search
~100-200.
"""

from __future__ import annotations

import numpy as np


def clustered(
    n: int,
    dim: int,
    num_queries: int,
    seed: int = 0x5EED,
    centers_per_64k: int = 256,
    center_scale: float = 0.7,
    query_noise: float = 1.0,
    dtype=np.float32,
    n_centers: int | None = None,
):
    """Gaussian-mixture dataset + queries.

    Cluster count scales with n (fixed expected cluster size ~256 points);
    `center_scale` sets separation relative to unit within-cluster noise —
    small values overlap clusters (harder, approaching the i.i.d.-gaussian
    regime where graph recall caps ~0.87), large values separate them
    trivially. `query_noise` perturbs query points away from their source
    dataset point (1.0 = as far as a fresh cluster sample). The defaults
    are tuned so recall@10 at M=32 first crosses 0.95 around
    ef_search ~100-300 — the SIFT1M operating band (reference grid
    experiments/Makefile:365-384).

    Returns (data [n, dim], queries [num_queries, dim]) in `dtype`.
    Queries are noise-perturbed dataset points (the ann-benchmarks
    convention: queries come from the same distribution).

    `n_centers` fixes the mixture's cluster count ABSOLUTELY instead of
    scaling it with n. Real datasets are denser samples of a FIXED
    distribution — SIFT-10M is not "10x the clusters of SIFT-1M" — and
    the round-3/4 A-B study (benchmarks/results_ab_uint8.json) showed
    cluster count scaling linearly with n collapses BOTH this engine and
    the reference C++ on identical bytes; a fixed center set is the
    honest way to scale one workload family across N.
    """
    rng = np.random.default_rng(seed)
    if n_centers is None:
        n_centers = max(8, (n * centers_per_64k) // 65536)
    centers = (
        rng.standard_normal((n_centers, dim)).astype(np.float32)
        * center_scale
    )
    assign = rng.integers(0, n_centers, n)
    data = centers[assign] + rng.standard_normal((n, dim)).astype(np.float32)
    qsrc = rng.choice(n, num_queries, replace=False)
    queries = data[qsrc] + query_noise * rng.standard_normal(
        (num_queries, dim)
    ).astype(np.float32)
    if np.issubdtype(np.dtype(dtype), np.integer):
        # quantize to the integer range (BigANN-style uint8 workloads)
        info = np.iinfo(dtype)
        lo, hi = np.percentile(data, [0.5, 99.5])
        scale = (info.max - info.min) / (hi - lo)
        q = lambda x: np.clip(
            np.round((x - lo) * scale) + info.min, info.min, info.max
        ).astype(dtype)
        return q(data), q(queries)
    return data.astype(dtype), queries.astype(dtype)


__all__ = ["clustered"]
