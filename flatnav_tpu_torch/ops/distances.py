"""Batched distance blocks (L2, inner product) and exact kNN ground truth.

Counterpart of flatnav_tpu/ops/distances.py. Metric conventions match the
reference: L2 is squared euclidean with no sqrt, IP distance is
1 - <x, y>. All distances come back in float32.

Precision: float32 products must run in full float32, the analog of JAX's
`Precision.HIGHEST`. TF32 keeps about three decimal digits, so this module
turns it off for cuBLAS matmuls and for cuDNN:

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

The one exception is `fast_knn`'s ranking pass, which takes the JAX
version's DEFAULT-precision form: bf16 operands, float32 accumulation
(`bf16_dot`); its rerank is exact.

Integer tables (uint8/int8) get exact products. cuBLAS has no int32 GEMM,
so `exact_int_dot` multiplies in float64: every partial sum is an integer
below 2^53 (|x.y| <= 255^2 * d), so the float64 product is exact in any
summation order and converts to int32 without loss. The H100 runs float64
on its tensor cores. This takes the place of the TPU's u8 -> s8 shift onto
the int8 MXU, which exists only to reach that unit.

Ties: every k-nearest selection here breaks ties to the lowest id. It ranks
one int64 key per entry, (order-preserving bits of the distance) << 32 | id,
so the order is total and no top-k implementation can reorder ties.
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class MetricType(enum.Enum):
    """Mirrors flatnav::distances::MetricType (DistanceInterface.h:14)."""

    L2 = "l2"
    IP = "ip"


def _is_int(x: torch.Tensor) -> bool:
    return not (x.dtype.is_floating_point or x.dtype.is_complex)


#: rows of an integer table widened to int32 at a time by `squared_norms`
_NORM_ROWS = 1 << 22


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, float32. x: [..., d] -> [...].

    Integer rows are widened to int32 `_NORM_ROWS` rows at a time (exact
    sums, so the chunking changes no bit): the whole widened copy of a
    100M x 128 uint8 table would take 51 GB."""
    if _is_int(x):
        flat = x.reshape(-1, x.shape[-1])
        out = torch.empty(flat.shape[0], dtype=torch.float32, device=x.device)
        for lo in range(0, flat.shape[0], _NORM_ROWS):
            xi = flat[lo : lo + _NORM_ROWS].to(torch.int32)
            out[lo : lo + _NORM_ROWS] = (xi * xi).sum(-1, dtype=torch.int32).to(torch.float32)
        return out.reshape(x.shape[:-1])
    xf = x.to(torch.float32)
    return (xf * xf).sum(-1)


def exact_int_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact int32 dot products x [B, d] . y [C, d] -> [B, C] (see the
    module docstring: a float64 product is exact for 8-bit inputs)."""
    return (x.to(torch.float64) @ y.to(torch.float64).T).to(torch.int32)


def pairwise_distances(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: MetricType,
    x_sq: torch.Tensor | None = None,
    y_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-pairs distances between x [B, d] and y [C, d] -> [B, C] float32,
    in the matmul form ||x||^2 - 2 x.y + ||y||^2 for L2."""
    if _is_int(x) and _is_int(y):
        dots_i = exact_int_dot(x, y)
        if metric == MetricType.IP:
            return 1.0 - dots_i.to(torch.float32)
        xs_i = (x.to(torch.int32) ** 2).sum(-1, dtype=torch.int32)
        ys_i = (y.to(torch.int32) ** 2).sum(-1, dtype=torch.int32)
        d2_i = xs_i[:, None] - 2 * dots_i + ys_i[None, :]
        return d2_i.clamp_min(0).to(torch.float32)

    dots = x.to(torch.float32) @ y.to(torch.float32).T
    if metric == MetricType.IP:
        return 1.0 - dots
    xs = squared_norms(x) if x_sq is None else x_sq
    ys = squared_norms(y) if y_sq is None else y_sq
    d2 = xs[:, None] - 2.0 * dots + ys[None, :]
    return d2.clamp_min(0.0)


def _tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis with a FIXED binary-tree association: zero-pad
    to a power of two, then add the upper half onto the lower half until
    one element is left. The gather-distance kernel reduces in exactly this
    order, so its results are bit-equal to this function's."""
    d = x.shape[-1]
    p = 1 << max(0, d - 1).bit_length()
    if p != d:
        x = torch.nn.functional.pad(x, (0, p - d))
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p : 2 * p]
    return x[..., 0]


def query_block_distances(
    queries: torch.Tensor, blocks: torch.Tensor, metric: MetricType
) -> torch.Tensor:
    """Distances from each query to its own block of vectors.

    queries: [B, d]; blocks: [B, M, d] -> [B, M] float32. The direct
    (q - v)^2 form is used for L2 (no matmul cancellation)."""
    if _is_int(queries) and _is_int(blocks):
        qi = queries.to(torch.int32)[:, None, :]
        bi = blocks.to(torch.int32)
        if metric == MetricType.IP:
            return 1.0 - (qi * bi).sum(-1, dtype=torch.int32).to(torch.float32)
        diff = qi - bi
        return (diff * diff).sum(-1, dtype=torch.int32).to(torch.float32)
    qf = queries.to(torch.float32)[:, None, :]
    bf = blocks.to(torch.float32)
    if metric == MetricType.IP:
        return 1.0 - _tree_sum_last(qf * bf)
    diff = qf - bf
    return _tree_sum_last(diff * diff)


def _rank_key(dists: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key ordered by (dist, id): the float's bits made monotone as a
    signed int32 (negative floats have their low 31 bits flipped), shifted
    above a non-negative 32-bit id. Adding +0.0 turns -0.0 into +0.0, so
    the two zeros tie and go to the lower id."""
    bits = (dists + 0.0).contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits << 32) | ids.to(torch.int64)


def _unrank_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    bits = key >> 32
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    dists = bits.to(torch.int32).view(torch.float32)
    return dists, (key & 0xFFFFFFFF).to(torch.int32)


def smallest_k(
    dists: torch.Tensor, ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest (dist, id) pairs of [B, W], ascending; ties go to
    the lowest id. ids must be non-negative and below 2^31."""
    key = _rank_key(dists, ids.expand_as(dists))
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return _unrank_key(top)


def bf16_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [B, d] . y [C, d] -> [B, C] float32 products of the bf16-rounded
    operands: the form of a DEFAULT-precision float32 dot on the TPU (one
    bf16 pass, float32 accumulation). On the card one bf16 tensor-core
    product with a float32 result (`out_dtype`); on the CPU, which has no
    such product, the float32 matmul of the same rounded operands. Both sum
    the same exact products, in different orders."""
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    if xb.is_cuda:
        return torch.mm(xb, yb.T, out_dtype=torch.float32)
    return xb.to(torch.float32) @ yb.to(torch.float32).T


def brute_force_knn(
    dataset: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: MetricType = MetricType.L2,
    tile_size: int = 65536,
    n_valid: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-nearest-neighbors by a tiled scan over the dataset.

    Returns (dists [B, k] ascending, ids [B, k] int32), ties to the lowest
    id. Rows at or past `n_valid` (default: all rows) are excluded. The
    last tile starts clamped and masks the rows the previous tile already
    covered, so the table is never pad-copied (only a table smaller than
    one tile is)."""
    n, d = dataset.shape
    b = queries.shape[0]
    n_limit = n if n_valid is None else int(n_valid)
    tile = max(min(tile_size, n), 128)
    if n < tile:  # tiny table only
        pad = torch.zeros((tile - n, d), dtype=dataset.dtype, device=dataset.device)
        dataset = torch.cat([dataset, pad])
        n = tile
    dev = dataset.device
    q_sq = None if _is_int(queries) else squared_norms(queries)
    best_d = torch.full((b, k), float("inf"), device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    iota = torch.arange(tile, dtype=torch.int32, device=dev)
    for start_raw in range(0, n, tile):
        start = min(start_raw, n - tile)
        rows = dataset[start : start + tile]
        dists = pairwise_distances(queries, rows, metric, x_sq=q_sq)
        ids = start + iota
        valid = (ids >= start_raw) & (ids < n_limit)
        dists = torch.where(valid, dists, float("inf"))
        best_d, best_i = smallest_k(
            torch.cat([best_d, dists], 1),
            torch.cat([best_i, ids.expand(b, tile)], 1),
            k,
        )
    return best_d, best_i


def fast_knn(
    dataset: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: MetricType = MetricType.L2,
    tile_size: int = 131072,
    rerank: int = 32,
    recall_target: float = 0.95,
    n_valid: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase kNN scan: a ranking-key pass keeps a `rerank`-wide
    shortlist per query, then the shortlist is reranked by exact distances,
    so the returned distances are exact.

    Phase-1 keys: integer tables rank by exact int32 keys; float tables by
    ||row||^2 - 2 q.row (or -q.row for IP) with the product taken over
    bf16-rounded operands and accumulated in float32 (`bf16_dot`), the form
    the JAX version's DEFAULT-precision dot takes on the TPU. The norms stay
    float32.

    The JAX version takes its per-tile shortlist with `approx_min_k` at
    `recall_target`; torch has no such call, so this one is exact
    (`smallest_k`) and `recall_target` bounds nothing. It is kept for the
    JAX signature's sake."""
    n, d = dataset.shape
    b = queries.shape[0]
    r = max(rerank, k)
    n_limit = n if n_valid is None else int(n_valid)
    tile = max(min(tile_size, n), 128)
    if n < tile:  # tiny table only
        pad = torch.zeros((tile - n, d), dtype=dataset.dtype, device=dataset.device)
        dataset = torch.cat([dataset, pad])
        n = tile
    dev = dataset.device
    int_path = _is_int(queries) and _is_int(dataset)
    qf = queries if int_path else queries.to(torch.float32)
    best_k = torch.full((b, r), float("inf"), device=dev)
    best_i = torch.zeros((b, r), dtype=torch.int32, device=dev)
    iota = torch.arange(tile, dtype=torch.int32, device=dev)
    for start_raw in range(0, n, tile):
        start = min(start_raw, n - tile)
        rows = dataset[start : start + tile]
        if int_path:
            dots_i = exact_int_dot(qf, rows)
            if metric == MetricType.IP:
                key = (-dots_i).to(torch.float32)
            else:
                ys_i = (rows.to(torch.int32) ** 2).sum(-1, dtype=torch.int32)
                key = (ys_i[None, :] - 2 * dots_i).to(torch.float32)
        else:
            dots = bf16_dot(qf, rows)
            key = -dots if metric == MetricType.IP else (
                squared_norms(rows)[None, :] - 2.0 * dots
            )
        ids = start + iota
        key = torch.where((ids >= start_raw) & (ids < n_limit), key, float("inf"))
        best_k, best_i = smallest_k(
            torch.cat([best_k, key], 1),
            torch.cat([best_i, ids.expand(b, tile)], 1),
            r,
        )
    # slots never filled by a valid row keep their inf key through the
    # rerank, or their id-0 rows would re-score finitely
    exact = query_block_distances(qf, dataset[best_i.long()], metric)
    exact = torch.where(torch.isinf(best_k), float("inf"), exact)
    order = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return exact.gather(1, order), best_i.gather(1, order)


__all__ = [
    "MetricType",
    "bf16_dot",
    "brute_force_knn",
    "exact_int_dot",
    "fast_knn",
    "pairwise_distances",
    "query_block_distances",
    "smallest_k",
    "squared_norms",
]
