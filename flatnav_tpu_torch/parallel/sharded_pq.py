"""Model-axis-sharded PQ-ADC scan over a device mesh.

Counterpart of flatnav_tpu/parallel/sharded_pq.py. PQ codes split by rows
over the mesh's `model` axis, exactly like the raw scan's table
(`sharded_exact`): every shard runs `pq_scan_knn` over its rows, reranks
its shortlist against its own raw rows when they are given (a candidate row
lives on one shard), offsets its ids to global ids, and the shards'
shortlists merge as in `sharded_exact.merge_shards`. The ADC tables and the
queries split over `data`.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from flatnav_tpu_torch.ops.distances import MetricType
from flatnav_tpu_torch.parallel.sharded_exact import merge_shards
from flatnav_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS, axis_index, axis_size, data_sharded
from flatnav_tpu_torch.quantization.pq import pq_scan_knn


def sharded_pq_scan(
    codes: torch.Tensor,  # this rank's rows [n_local, S] uint8 (`shard_rows`)
    tables,  # [B, S, nc] f32 ADC tables (pq.adc_tables), global
    num_nodes: int,  # global committed prefix
    mesh: DeviceMesh,
    *,
    k: int,
    metric: MetricType = MetricType.L2,
    rerank: int = 32,
    tile_size: int = 32768,
    vectors: torch.Tensor | None = None,  # this rank's raw rows, for the rerank
    queries=None,  # [B, d] global, for the raw rerank
    packed_4bit: bool = False,  # two 4-bit codes a byte
):
    """PQ-ADC kNN over a row-sharded code table -> (dists [B, k], ids
    [B, k]) with global row ids, on every rank. With `vectors` + `queries`
    each shard reranks its shortlist by exact distances to its own raw
    rows; otherwise ranking is exact-f32 ADC."""
    n_local = codes.shape[0]
    raw = vectors is not None and queries is not None
    if raw and vectors.shape[0] != n_local:
        raise ValueError(f"vectors rows {vectors.shape[0]} != code rows {n_local}")
    offset = axis_index(mesh, MODEL_AXIS) * n_local
    local_valid = min(max(num_nodes - offset, 0), n_local)
    t_local = data_sharded(tables, mesh)
    d_loc, i_loc = pq_scan_knn(
        codes, t_local, k, metric=metric, tile_size=tile_size, rerank=rerank,
        n_valid=local_valid, vectors=vectors if raw else None,
        queries=data_sharded(queries, mesh) if raw else None,
        packed_4bit=packed_4bit,
    )
    return merge_shards(d_loc, i_loc + offset, mesh, k, t_local.shape[0] * axis_size(mesh, DATA_AXIS))


__all__ = ["sharded_pq_scan"]
