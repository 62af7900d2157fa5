"""Query-sharded (data-parallel) beam search over a device mesh.

Counterpart of flatnav_tpu/parallel/sharded_search.py. The reference runs
a batch's queries on a thread pool (python-bindings/src/flatnav/
bindings.cpp:198-211); here the batch splits over the mesh's `data` axis
with the graph whole on every rank: each rank runs the single-device beam
search (K2 on every hop) on its slice, with no traffic between ranks until
the results are gathered. Node-table sharding, for graphs larger than one
device, is `sharded_graph.sharded_search`.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from flatnav_tpu_torch.index.search import (
    SearchResults,
    beam_search_core,
    safe_query_batch,
    table_blocks,
)
from flatnav_tpu_torch.ops.distances import MetricType
from flatnav_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    axis_range,
    axis_size,
    gather_slice,
    psum,
    replicated,
)


def data_parallel_search(
    graph,
    queries,
    mesh: DeviceMesh,
    *,
    k: int,
    ef: int,
    metric: MetricType = MetricType.L2,
    num_initializations: int = 100,
) -> SearchResults:
    """Batched search with the queries ([B, d], the same global batch on
    every rank; B must divide by the data axis) split over `data` and the
    graph whole on every rank. Every rank returns the whole result, equal to
    the single-device `batched_search`'s."""
    n_data = axis_size(mesh, DATA_AXIS)
    queries = torch.as_tensor(queries)
    b = queries.shape[0]
    if b % n_data:
        raise ValueError(f"query batch {b} not divisible by data axis {n_data}")
    vectors, links, labels = (replicated(t, mesh) for t in (graph.vectors, graph.links, graph.labels))
    ef = max(ef, k)
    # memory guard at one rank's width: each rank holds the whole graph and
    # the hop working set of its b / n_data queries
    table_bytes = vectors.numel() * vectors.element_size() + links.numel() * 4 + labels.numel() * 4
    sub = n_data * safe_query_batch(
        b // n_data, ef, m=links.shape[1], d=vectors.shape[1],
        table_bytes=table_bytes, device=vectors.device,
    )
    dists, labs, counts = [], [], 0
    for lo in range(0, b, sub):
        q_all = queries[lo : lo + sub].to(vectors.device)
        bd = q_all.shape[0]
        r0, r1 = axis_range(mesh, DATA_AXIS, bd)
        score, _ = table_blocks(vectors, q_all[r0:r1], metric)
        # the entry scan for the whole dispatch, sliced: the single-device
        # matmul, whatever its rounding at this batch width
        _, entry_all = table_blocks(vectors, q_all, metric)
        beam = beam_search_core(
            links, graph.num_nodes, r1 - r0, score, lambda c: entry_all(c)[r0:r1],
            ef=ef, num_initializations=num_initializations,
        )
        top_d, top_i = beam.dists[:, :k], beam.ids[:, :k]
        lab = torch.where(torch.isfinite(top_d), labels[top_i.long()], -1)
        dists.append(gather_slice(top_d, bd, r0, mesh, DATA_AXIS))
        labs.append(gather_slice(lab, bd, r0, mesh, DATA_AXIS))
        counts = counts + psum(torch.stack([beam.dist_computations, beam.hops]), mesh, DATA_AXIS)
    return SearchResults(torch.cat(dists), torch.cat(labs), int(counts[0]), int(counts[1]))


__all__ = ["data_parallel_search"]
