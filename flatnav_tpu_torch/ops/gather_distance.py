"""Fused gather + distance for the beam-search hop (kernel K2).

Counterpart of flatnav_tpu/ops/gather_distance.py. The hop scores candidate
ids against their query: `out[b, c] = dist(queries[b], vectors[ids[b, c]])`.

On a CUDA tensor `gather_distances` launches the hand-written kernel
`csrc/gather_distance.cu` (it replaces the Pallas TPU kernel
flatnav_tpu/ops/gather_distance.py:_kernel); on a CPU tensor it runs
`gather_distances_plain`, the plain PyTorch version of the same function.
The kernel reads each candidate row once and never materializes the
[B, C, d] gathered block; it is bound by those row bytes (see the source).
Both reduce over d in the fixed tree order of `_tree_sum_last` (the kernel
in registers: in-lane adds, then warp shuffles), so the kernel is bit-equal
to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.ops.distances import MetricType, query_block_distances

_VEC_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def gather_distances_plain(
    vectors: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    metric: MetricType = MetricType.L2,
) -> torch.Tensor:
    """Plain version: gather the [B, C, d] block, then
    `query_block_distances`."""
    return query_block_distances(
        queries.to(torch.float32), vectors[ids.long()], metric
    )


def _lib():
    lib = _build.load("gather_distance")
    fn = lib.gather_distance_launch
    if not fn.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def gather_distances(
    vectors: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    metric: MetricType = MetricType.L2,
) -> torch.Tensor:
    """`dist(queries[b], vectors[ids[b, c]])` -> [B, C] float32.

    vectors: [N, d] float32/bfloat16/float16 with d <= 4096; ids: [B, C]
    int32 in [0, N) (the kernel scores an id outside that range NaN);
    queries: [B, d].
    `gather_distances.launches` counts kernel launches."""
    if vectors.device.type == "cpu":
        return gather_distances_plain(vectors, ids, queries, metric)
    if vectors.dtype not in _VEC_TYPES:
        raise TypeError(f"gather_distances: unsupported table dtype {vectors.dtype}")
    n, d = vectors.shape
    b, c = ids.shape
    if queries.shape != (b, d):
        raise ValueError(f"queries {tuple(queries.shape)} do not match ids {b} x d {d}")
    if not (ids.device == queries.device == vectors.device):
        raise ValueError("gather_distances: tensors are on different devices")
    vectors = vectors.contiguous()
    ids = ids.to(torch.int32).contiguous()
    q = queries.to(torch.float32).contiguous()
    out = torch.empty((b, c), dtype=torch.float32, device=vectors.device)
    rc = _lib()(
        vectors.data_ptr(), _VEC_TYPES[vectors.dtype], ids.data_ptr(),
        q.data_ptr(), n, d, b, c, int(metric == MetricType.IP),
        out.data_ptr(), torch.cuda.current_stream(vectors.device).cuda_stream,
    )
    _build.check(rc, "gather_distances")
    gather_distances.launches += 1
    return out


gather_distances.launches = 0

__all__ = ["gather_distances", "gather_distances_plain"]
