"""The benchmark's data: a seeded Gaussian mixture at a configuration's shapes.

The same mixture as the port's `bench/synth.clustered` (cluster count scaled
with n, `centers_per_64k` clusters per 65,536 rows, centres scaled by
`center_scale` against unit noise, queries that are dataset rows moved by
`query_noise` of fresh noise), rewritten in torch so that it is drawn on the
device: numpy takes tens of seconds for GIST's 960 million floats. The draws
come from one `torch.Generator` seeded with the run's seed, in a few large
calls, so one seed on one kind of device gives the same arrays every time.
"""

from __future__ import annotations

import torch

#: a seed as the benchmark takes it (any whole number) -> the generator's
#: seed, which must lie in [0, 2^64)
_SEED_MASK = (1 << 64) - 1


def clustered(n: int, dim: int, num_queries: int, seed: int, device,
              centers_per_64k: int = 26, center_scale: float = 0.7,
              query_noise: float = 1.0):
    """-> (data [n, dim], queries [num_queries, dim]) float32 on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _SEED_MASK)
    n_centers = max(8, (n * centers_per_64k) // 65536)
    centers = torch.randn((n_centers, dim), generator=g, device=device) * center_scale
    assign = torch.randint(0, n_centers, (n,), generator=g, device=device)
    data = torch.randn((n, dim), generator=g, device=device)
    data += centers[assign]
    del assign, centers
    src = torch.randperm(n, generator=g, device=device)[:num_queries]
    queries = data[src] + query_noise * torch.randn(
        (num_queries, dim), generator=g, device=device)
    return data, queries


def generate(cfg: dict, seed: int, device):
    """The configuration's (data, queries) for `seed`, by its `generator`
    entry."""
    gen = dict(cfg["generator"])
    kind = gen.pop("kind")
    if kind != "clustered":
        raise ValueError(f"unknown generator {kind!r}")
    return clustered(cfg["n"], cfg["dim"], cfg["num_queries"], seed, device, **gen)
