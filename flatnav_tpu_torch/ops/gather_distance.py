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
in registers up to p = 2048, past it through a carry stack of chunk roots in
shared memory; in-lane adds, then warp shuffles), so the kernel is bit-equal
to the plain version at every d.
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
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """`dist(queries[b], vectors[ids[b, c]])` -> [B, C] float32.

    vectors: [N, d] float32/bfloat16/float16, any d; ids: [B, C]
    int32 in [0, N) (the kernel scores an id outside that range NaN and
    loads no row for it: the search hands it -1 where a candidate is not
    fresh); queries: [B, d]. `out`: a contiguous [B, C] float32 tensor on
    the table's device to write into and return (the search's hop binds
    one for all its calls); None: a new one.
    `gather_distances.launches` counts kernel launches."""
    b, c = ids.shape
    if out is not None and not (out.shape == (b, c) and out.dtype == torch.float32
                                and out.is_contiguous() and out.device == vectors.device):
        raise ValueError(f"gather_distances: out {tuple(out.shape)} {out.dtype} on {out.device}, "
                         f"want a contiguous [{b}, {c}] float32 on {vectors.device}")
    if vectors.device.type == "cpu":
        got = gather_distances_plain(vectors, ids, queries, metric)
        return got if out is None else out.copy_(got)
    if vectors.dtype not in _VEC_TYPES:
        raise TypeError(f"gather_distances: unsupported table dtype {vectors.dtype}")
    n, d = vectors.shape
    if queries.shape != (b, d):
        raise ValueError(f"queries {tuple(queries.shape)} do not match ids {b} x d {d}")
    if not (ids.device == queries.device == vectors.device):
        raise ValueError("gather_distances: tensors are on different devices")
    vectors = vectors.contiguous()
    ids = ids.to(torch.int32).contiguous()
    q = queries.to(torch.float32).contiguous()
    if out is None:
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
