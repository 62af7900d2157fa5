"""On-device k-means (Lloyd's algorithm) for PQ codebook training.

Counterpart of flatnav_tpu/quantization/kmeans.py, after the reference's
CentroidsGenerator (developmental-features/quantization/CentroidsGenerator.h):
the OpenMP assignment/update loops (97-152) become one distance block and
one one-hot matmul per iteration, for the default 62 iterations
(CentroidsGenerator.h:40-49).

Initializers mirror the reference: random sample (167-182), kmeans++
(199-252), hypercube (280-309). Initialization runs on the host (offline,
once) from `np.random.default_rng(seed)`, so this package and the JAX one
start from identical centroids; the iterations run on `device`.

The update is the one-hot matmul and not `index_add_`: on the card the
latter adds with atomics in no fixed order, and training would not repeat
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flatnav_tpu_torch.data_type import host_tensor, resolve_device
from flatnav_tpu_torch.ops.distances import MetricType, pairwise_distances


def _init_random(data: np.ndarray, k: int, rng: np.random.Generator):
    idx = rng.choice(data.shape[0], size=k, replace=data.shape[0] < k)
    return data[idx].astype(np.float32)


def _init_kmeanspp(data: np.ndarray, k: int, rng: np.random.Generator):
    """kmeans++ seeding (CentroidsGenerator.h:199-252)."""
    n = data.shape[0]
    centroids = np.empty((k, data.shape[1]), np.float32)
    centroids[0] = data[rng.integers(n)]
    d2 = ((data - centroids[0]) ** 2).sum(1)
    for i in range(1, k):
        total = d2.sum()
        if total > 1e-12:
            centroids[i] = data[rng.choice(n, p=d2 / total)]
        else:
            # degenerate: every remaining point coincides with a chosen
            # centroid (fewer than k distinct rows) — fall back to uniform
            # sampling instead of crashing on an all-zero distribution
            centroids[i] = data[rng.integers(n)]
        d2 = np.minimum(d2, ((data - centroids[i]) ** 2).sum(1))
    return centroids


def _init_hypercube(data: np.ndarray, k: int, rng: np.random.Generator):
    """Hypercube init (CentroidsGenerator.h:280-309): mean +- spread on the
    first log2(k) axes."""
    d = data.shape[1]
    nbits = max(int(np.log2(k)), 1)
    mean = data.mean(0)
    spread = data.std(0).mean() / 2.0
    centroids = np.tile(mean, (k, 1)).astype(np.float32)
    for i in range(k):
        for b in range(min(nbits, d)):
            centroids[i, b] += spread if (i >> b) & 1 else -spread
    return centroids


_INITS = {
    "default": _init_random,
    "random": _init_random,
    "kmeans++": _init_kmeanspp,
    "hypercube": _init_hypercube,
}


def _lloyd(
    data: torch.Tensor, centroids: torch.Tensor, n_iters: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n_iters` Lloyd steps from `centroids` -> (centroids [k, d] float32,
    assignment [n] int64)."""
    k = centroids.shape[0]
    cents = centroids
    for _ in range(n_iters):
        assign = torch.argmin(pairwise_distances(data, cents, MetricType.L2), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        sums = one_hot.T @ data
        counts = one_hot.sum(0)
        new = sums / counts[:, None].clamp_min(1.0)
        # empty clusters keep their previous centroid
        cents = torch.where(counts[:, None] > 0, new, cents)
    assign = torch.argmin(pairwise_distances(data, cents, MetricType.L2), dim=1)
    return cents, assign


def kmeans(
    data: np.ndarray,
    k: int,
    n_iters: int = 62,
    init: str = "default",
    seed: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train k centroids; returns (centroids [k, d] f32, assignment [n]),
    both on `device` (the card unless the caller asks for "cpu")."""
    if init not in _INITS:
        raise ValueError(f"unknown init {init!r}; options: {sorted(_INITS)}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = np.asarray(data, dtype=np.float32)
    cents0 = _INITS[init](data, k, rng)
    return _lloyd(
        host_tensor(data).to(dev), host_tensor(cents0).to(dev), n_iters
    )
