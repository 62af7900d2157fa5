"""Model-axis-sharded exact and two-phase kNN scans over a device mesh.

Counterpart of flatnav_tpu/parallel/sharded_exact.py. The table's rows
split over the mesh's `model` axis and the queries over `data`. Each shard
scans its own rows with the engine the flags pick, `brute_force_knn`
(rerank=0), `fast_knn` (rerank>0) or `fused_knn` (rerank>0, fused: kernel
K1 on every shard), offsets its ids to global ids, and the shards' [B, k]
shortlists are gathered and merged by a stable sort in shard order, which is
row-id order: ties go to the lowest id, as on one device.

A row lives on one shard, so the candidate sets partition the table: the
exact scan returns the single-device scan's ids. The two-phase engines take
a `rerank`-wide shortlist on every shard, so they rerank S times as many
candidates as one device does and can return better neighbours, never worse.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from flatnav_tpu_torch.ops.distances import MetricType, brute_force_knn, fast_knn
from flatnav_tpu_torch.ops.fused_scan import fused_knn
from flatnav_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather,
    axis_index,
    axis_size,
    data_sharded,
    gather_slice,
)


def merge_shards(d_loc, i_glob, mesh: DeviceMesh, k: int, b: int):
    """Gather every shard's [b_local, k] shortlist over `model`, keep the k
    best of the S*k (a stable sort in shard order), then gather the query
    slices over `data` -> ([b, k], [b, k]) on every rank."""
    n_model = axis_size(mesh, MODEL_AXIS)
    b_local = d_loc.shape[0]
    all_d = all_gather(d_loc, mesh, MODEL_AXIS)  # [S, b_local, k]
    all_i = all_gather(i_glob.to(torch.int32), mesh, MODEL_AXIS)
    cat_d = all_d.permute(1, 0, 2).reshape(b_local, n_model * k)
    cat_i = all_i.permute(1, 0, 2).reshape(b_local, n_model * k)
    order = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
    lo = axis_index(mesh, DATA_AXIS) * b_local
    return (
        gather_slice(cat_d.gather(1, order), b, lo, mesh, DATA_AXIS),
        gather_slice(cat_i.gather(1, order), b, lo, mesh, DATA_AXIS),
    )


def sharded_exact_search(
    vectors: torch.Tensor,  # this rank's rows [n_local, d] (`shard_rows`)
    num_nodes: int,  # global committed prefix
    queries,  # [B, d] global, the same on every rank
    mesh: DeviceMesh,
    *,
    k: int,
    metric: MetricType = MetricType.L2,
    rerank: int = 0,
    tile_size: int = 65536,
    fused: bool = False,
):
    """Exact (rerank=0) or two-phase (rerank>0) kNN over a row-sharded table.
    Returns (dists [B, k], ids [B, k]) with global row ids, on every rank.
    The batch must divide by the data axis. `fused=True` takes the
    rerank>0 shortlist with `fused_knn` (K1) on each shard."""
    n_local = vectors.shape[0]
    offset = axis_index(mesh, MODEL_AXIS) * n_local
    # committed rows this shard owns: the global prefix, clamped
    local_valid = min(max(num_nodes - offset, 0), n_local)
    q_local = data_sharded(queries, mesh)
    if rerank > 0 and fused:
        d_loc, i_loc = fused_knn(vectors, q_local, k, metric, rerank=rerank, n_valid=local_valid)
    elif rerank > 0:
        d_loc, i_loc = fast_knn(
            vectors, q_local, k, metric, tile_size=tile_size, rerank=rerank, n_valid=local_valid
        )
    else:
        d_loc, i_loc = brute_force_knn(
            vectors, q_local, k, metric, tile_size=tile_size, n_valid=local_valid
        )
    return merge_shards(d_loc, i_loc + offset, mesh, k, q_local.shape[0] * axis_size(mesh, DATA_AXIS))


def shards_on_one_device(scan, table: torch.Tensor, num_nodes: int, n_model: int, k: int):
    """What a model-sharded scan returns, computed on one device: the rows
    of `table` split as `shard_rows` splits them, each shard scanned in turn
    by `scan(rows, n_valid) -> (dists [B, k], local ids [B, k])`, and the
    shortlists merged as `merge_shards` merges them. The reference the
    sharded scans are held to."""
    n_local = -(-table.shape[0] // n_model)
    pad = n_local * n_model - table.shape[0]
    if pad:
        table = torch.cat([table, table.new_zeros((pad,) + tuple(table.shape[1:]))])
    ds, ids = [], []
    for s in range(n_model):
        lo = s * n_local
        d, i = scan(table[lo : lo + n_local], min(max(num_nodes - lo, 0), n_local))
        ds.append(d)
        ids.append(i + lo)
    cat_d, cat_i = torch.cat(ds, 1), torch.cat(ids, 1).to(torch.int32)
    order = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
    return cat_d.gather(1, order), cat_i.gather(1, order)


__all__ = ["merge_shards", "sharded_exact_search", "shards_on_one_device"]
