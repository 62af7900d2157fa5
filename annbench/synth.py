"""The benchmark's data: a seeded Gaussian mixture at a configuration's shapes,
in the configuration's form.

The same mixture as the port's `bench/synth.clustered` (cluster count scaled
with n, `centers_per_64k` clusters per 65,536 rows, centres scaled by
`center_scale` against unit noise, queries that are dataset rows moved by
`query_noise` of fresh noise), rewritten in torch so that it is drawn on the
device: numpy takes tens of seconds for GIST's 960 million floats. The draws
come from one `torch.Generator` seeded with the run's seed, in a few large
calls, so one seed on one kind of device gives the same arrays every time.

Every configuration makes the same draws in the same order; its form
(`registry.form`) is applied to them after:
- `angular`: rows and queries divided by their L2 norms, in float32, as the
  port's north-star runner does (`bench/northstar.make_data`);
- `uint8` / `int8`: rows and queries mapped to the type's range as
  `bench/synth.clustered`'s integer path does (`to_integer`).
A float32 `l2` configuration's arrays are the draws themselves.
"""

from __future__ import annotations

import math

import torch

from annbench.registry import form

#: a seed as the benchmark takes it (any whole number) -> the generator's
#: seed, which must lie in [0, 2^64)
_SEED_MASK = (1 << 64) - 1
#: the share of the rows' values below the integer range's ends, in percent
PERCENTILES = (0.5, 99.5)
#: elements mapped to integers at a time (a float64 block of 512 MB)
_MAP_BLOCK = 1 << 26


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


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm (+1e-12, as the north-star runner adds), in
    place, float32."""
    return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True).add_(1e-12))


def percentiles(x: torch.Tensor, qs=PERCENTILES) -> list[float]:
    """numpy's `np.percentile(x, qs)` (its default, linear interpolation),
    value for value, computed on `x`'s device.

    Exact order statistics, not a sample: `torch.topk` takes the few values
    below each rank from the whole tensor (`torch.quantile` refuses inputs
    past 2^24 elements), and the two neighbours are interpolated as numpy's
    `_lerp` does, their difference in `x`'s type and the rest in float64."""
    flat = x.reshape(-1)
    n = flat.numel()
    out = []
    for q in qs:
        pos = (n - 1) * (q / 100)
        r = math.floor(pos)
        g = pos - r
        if r + 1 <= n // 2:  # the values of ranks r, r + 1 from below
            v = torch.topk(flat, min(r + 2, n), largest=False).values
            a, b = v[r], v[min(r + 1, n - 1)]
        else:  # from above: rank r is the (n - 1 - r)-th largest
            v = torch.topk(flat, n - r, largest=True).values
            a, b = v[n - 1 - r], v[max(n - 2 - r, 0)]
        diff = float(b - a)
        a, b = float(a), float(b)
        out.append(b - diff * (1 - g) if g >= 0.5 else a + diff * g)
    return out


def to_integer(x: torch.Tensor, lo: float, hi: float, dtype: torch.dtype) -> torch.Tensor:
    """`bench/synth.clustered`'s integer mapping: [lo, hi] scaled onto the
    type's range, rounded half to even, clipped; in float64, as numpy computes
    a float32 array against float64 percentiles."""
    info = torch.iinfo(dtype)
    scale = (info.max - info.min) / (hi - lo)
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=dtype, device=x.device)
    for s in range(0, flat.numel(), _MAP_BLOCK):
        y = (flat[s : s + _MAP_BLOCK].double() - lo) * scale
        out[s : s + _MAP_BLOCK] = y.round_().add_(info.min).clamp_(info.min, info.max)
    return out.view(x.shape)


def generate(cfg: dict, seed: int, device):
    """The configuration's (data, queries) for `seed`, by its `generator`
    entry, in its form: float32, or `dtype` for 8-bit rows."""
    metric, dtype = form(cfg)
    gen = dict(cfg["generator"])
    kind = gen.pop("kind")
    if kind != "clustered":
        raise ValueError(f"unknown generator {kind!r}")
    data, queries = clustered(cfg["n"], cfg["dim"], cfg["num_queries"], seed, device, **gen)
    if metric == "angular":
        data, queries = unit_rows(data), unit_rows(queries)
    if dtype != "float32":
        lo, hi = percentiles(data)
        tdt = getattr(torch, dtype)
        data = to_integer(data, lo, hi, tdt)
        queries = to_integer(queries, lo, hi, tdt)
    return data, queries
