"""Rank programs: the multi-device dry run and a runner of sharded cases.

`dryrun_multichip(n, device=..., backend=...)` is the counterpart of
`__graft_entry__.dryrun_multichip` (:105-286): on an n-rank mesh (data 2
where n is even) at the same tiny shapes it builds a model-sharded graph,
searches it model-sharded and data-parallel, runs the sharded exact and
fused scans, builds and searches a table larger than a shard, then a PQ
index, the sharded PQ scan and its 4-bit form, and checks every output.

`run_meshes(runs, device_type, dryrun)` runs several meshes and the dry
run in one start of the ranks. `run_cases(cases, data, model, device_type)`
runs in every rank of a
`(data, model)` mesh: each case names a sharded engine, its global numpy
inputs and its options, and rank 0 returns each case's outputs as numpy
arrays with its seconds and every rank's kernel launches. The tests and
`chip_smoke.py` hold those outputs against the single-device port and the
JAX package; the runner lives here so that no rank imports a test module.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from flatnav_tpu_torch.data_type import from_numpy
from flatnav_tpu_torch.index import build as build_mod
from flatnav_tpu_torch.index import search as search_mod
from flatnav_tpu_torch.index.build import add_batch
from flatnav_tpu_torch.index.graph import GraphArrays, make_empty_graph
from flatnav_tpu_torch.ops.distances import MetricType
from flatnav_tpu_torch.ops.fused_scan import scan_buckets
from flatnav_tpu_torch.ops.gather_distance import gather_distances
from flatnav_tpu_torch.parallel.launch import run_ranks
from flatnav_tpu_torch.parallel.sharded_exact import sharded_exact_search
from flatnav_tpu_torch.parallel.sharded_graph import sharded_search
from flatnav_tpu_torch.parallel.sharded_pq import sharded_pq_scan
from flatnav_tpu_torch.parallel.sharded_search import data_parallel_search
from flatnav_tpu_torch.parallel.sharding import (
    MODEL_AXIS,
    ShardedGraph,
    axis_size,
    make_mesh,
    mesh_device,
    shard_rows,
    unshard_rows,
)
from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer, pack_codes_4bit


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _host_graph(g: dict) -> GraphArrays:
    """A graph on the host from a dict of numpy arrays (vectors, links,
    labels, num_nodes, capacity)."""
    return GraphArrays(
        from_numpy(g["vectors"]), from_numpy(g["links"]), from_numpy(g["labels"]),
        int(g["num_nodes"]), int(g["capacity"]),
    )


def _results(res) -> dict:
    return {"dists": res.dists.cpu().numpy(), "labels": res.labels.cpu().numpy(),
            "dist_computations": res.dist_computations, "hops": res.hops}


def _pair(d, i) -> dict:
    return {"dists": d.cpu().numpy(), "ids": i.cpu().numpy()}


def _case_search(mesh, graph, queries, **kw):
    return _results(sharded_search(_host_graph(graph), queries, mesh, **kw))


def _case_dp_search(mesh, graph, queries, **kw):
    return _results(data_parallel_search(_host_graph(graph), queries, mesh, **kw))


def _case_exact(mesh, vectors, num_nodes, queries, **kw):
    return _pair(*sharded_exact_search(shard_rows(vectors, mesh), num_nodes, queries, mesh, **kw))


def _case_pq(mesh, codes, tables, num_nodes, vectors=None, queries=None, **kw):
    raw = {} if vectors is None else {"vectors": shard_rows(vectors, mesh), "queries": queries}
    return _pair(*sharded_pq_scan(shard_rows(codes, mesh), tables, num_nodes, mesh, **raw, **kw))


def _case_build(mesh, data, capacity, max_edges, table_spec, **kw):
    """Builds from empty; returns the first `rows` rows of the graph (rows
    gathered over `model` under "model") and the build's counters."""
    d = data.shape[1]
    dtype = from_numpy(data[:1]).dtype
    empty = make_empty_graph(capacity, d, max_edges, dtype, device="cpu")
    stats = {}
    g = add_batch(empty, data, np.arange(data.shape[0]), mesh=mesh, table_spec=table_spec,
                  stats=stats, **kw)
    rows = empty.vectors.shape[0]
    if isinstance(g, ShardedGraph):
        arrays = {name: unshard_rows(getattr(g, name), rows, mesh) for name in ("vectors", "links", "labels")}
        arrays["shard_rows"] = g.vectors.shape[0]
    else:
        arrays = {name: getattr(g, name)[:rows].cpu().numpy() for name in ("vectors", "links", "labels")}
    return {**arrays, "num_nodes": g.num_nodes, **stats}


def _case_mismatch(mesh):
    """Ranks that disagree on a collective: rank 0 sums over `model`, the
    others over the whole world. Neither returns."""
    t = torch.ones(1, device=mesh_device(mesh))
    if dist.get_rank() == 0:
        dist.all_reduce(t, group=mesh.get_group(MODEL_AXIS))
    else:
        dist.all_reduce(t)
    return {}


_CASES = {
    "search": _case_search,
    "dp_search": _case_dp_search,
    "exact": _case_exact,
    "pq": _case_pq,
    "build": _case_build,
    "mismatch": _case_mismatch,
}


def _launches(mesh) -> np.ndarray:
    """[world, 2] K1 and K2 launches of every rank since the last reset."""
    world, rank = dist.get_world_size(), dist.get_rank()
    buf = torch.zeros((world, 2), dtype=torch.int64, device=mesh_device(mesh))
    buf[rank] = torch.tensor([scan_buckets.launches, gather_distances.launches])
    dist.all_reduce(buf)
    return buf.cpu().numpy()


def run_cases(cases, data: int, model: int, device_type: str):
    """Rank program: run each case ({"op": name of `_CASES`, "args": {...}},
    optionally "mem_limit": bytes the memory guards take as the card's) on
    a (data, model) mesh. Returns a list with, for each case, its outputs,
    "seconds" (host clock, synchronised) and "launches" ([world, 2]: K1
    and K2 per rank)."""
    mesh = make_mesh(data, model, device_type=device_type)
    out = []
    for case in cases:
        limit = case.get("mem_limit")
        saved = search_mod._device_mem_limit
        if limit is not None:
            search_mod._device_mem_limit = build_mod._device_mem_limit = lambda device: limit
        scan_buckets.launches = gather_distances.launches = 0
        try:
            if device_type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _CASES[case["op"]](mesh, **case.get("args", {}))
            if device_type == "cuda":
                torch.cuda.synchronize()
            res["seconds"] = time.perf_counter() - t0
        finally:
            search_mod._device_mem_limit = build_mod._device_mem_limit = saved
        res["launches"] = _launches(mesh)
        out.append(res)
    return out


def run_meshes(runs, device_type: str, dryrun: bool = False):
    """Rank program: `run_cases` on each (data, model, cases) of `runs` in
    turn, every mesh over the one process group, then (with `dryrun`) the
    dry run on all its ranks. -> [each run's `run_cases` list ..., the dry
    run's summary or None]. One start of the ranks serves every mesh."""
    out = [run_cases(cases, data, model, device_type) for data, model, cases in runs]
    out.append(_dryrun_rank(dist.get_world_size(), device_type) if dryrun else None)
    return out


def dryrun_multichip(n_devices: int, *, device: str, backend: str, timeout: float = 600) -> dict:
    """The JAX package's multi-chip dry run on `n_devices` ranks (see the
    module docstring); raises if any step's output is wrong. Returns rank
    0's summary."""
    return run_ranks(_dryrun_rank, n_devices, backend=backend, device=device, timeout=timeout,
                     args=(n_devices, device))


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    data_ax = 2 if n_devices % 2 == 0 else 1
    model_ax = n_devices // data_ax
    mesh = make_mesh(data_ax, model_ax, device_type=device_type)
    dev = mesh_device(mesh)
    L2 = MetricType.L2

    rng = np.random.default_rng(0)
    n, d, m = 512, 32, 8
    data = rng.standard_normal((n, d), dtype=np.float32)

    # construction on a model-sharded table: waves split over `data`, rows
    # over `model`; search, prune and both edge commits run on the shards
    g = add_batch(make_empty_graph(n, d, m, device="cpu"), data, np.arange(n), ef_construction=16,
                  metric=L2, max_wave=128, mesh=mesh, table_spec="model")
    _check(g.num_nodes == n, "the model-sharded build committed every node")

    queries = rng.standard_normal((16 * data_ax, d), dtype=np.float32)
    res = sharded_search(g, queries, mesh, k=5, ef=16)
    _check(bool(torch.isfinite(res.dists).all()) and bool((res.labels >= 0).all()), "sharded search")

    # exact and fused scans over the same row-sharded table
    ed, ei = sharded_exact_search(g.vectors, g.num_nodes, queries, mesh, k=5)
    _check(bool(torch.isfinite(ed).all()) and bool((ei >= 0).all()), "sharded exact scan")
    fd, fi = sharded_exact_search(g.vectors, g.num_nodes, queries, mesh, k=5, rerank=16, fused=True)
    _check(bool((fi >= 0).all()), "sharded fused scan")

    # data-parallel search: the whole graph on every rank, queries over `data`
    full = GraphArrays(
        *(torch.from_numpy(unshard_rows(getattr(g, f), g.rows, mesh)) for f in ("vectors", "links", "labels")),
        g.num_nodes, g.capacity,
    )
    dres = data_parallel_search(full, queries, mesh, k=5, ef=16)
    _check(bool(torch.isfinite(dres.dists).all()), "data-parallel search")

    # a table larger than one shard: every rank holds rows / model of it
    n_big = 1024 * model_ax if model_ax > 1 else 2048
    big = rng.standard_normal((n_big, d), dtype=np.float32)
    gb = add_batch(make_empty_graph(n_big, d, m, device="cpu"), big, np.arange(n_big),
                   ef_construction=16, metric=L2, max_wave=256, mesh=mesh, table_spec="model")
    _check(gb.num_nodes == n_big, "the large model-sharded build committed every node")
    _check(gb.vectors.shape[0] == -(-gb.rows // model_ax), "each rank holds rows / model")
    bres = sharded_search(gb, queries, mesh, k=5, ef=16)
    _check(bool(torch.isfinite(bres.dists).all()), "search of the large sharded table")

    # PQ under the same mesh: a PQ graph index with ADC beam search and the
    # ADC scan, each whole on every rank
    pq = ProductQuantizer(dim=d, num_subquantizers=4, device=dev).train(data[:256], n_iters=5)
    pidx = PQIndex(pq, dataset_size=n, max_edges_per_node=m)
    pidx.add(data, ef_construction=16, max_wave=256)
    pd, pl = pidx.search(queries, K=5, ef_search=16)
    _check(np.isfinite(pd).all() and (pl >= 0).all(), "PQ graph search")
    sd, sl = pidx.search_scan(queries, K=5, rerank=8)
    _check(np.isfinite(sd).all() and (sl >= 0).all(), "PQ scan")

    # the sharded PQ-ADC scan, codes and raw rows split alike over `model`
    vec_shard = shard_rows(data, mesh)
    codes = shard_rows(pq.encode(data), mesh)
    spd, spi = sharded_pq_scan(codes, pq.adc_tables(queries), n, mesh, k=5, tile_size=128, rerank=8,
                               vectors=vec_shard, queries=queries)
    _check(bool(torch.isfinite(spd).all()) and bool((spi < n).all()), "sharded PQ scan")

    # its 4-bit, two-codes-a-byte form
    pq4 = ProductQuantizer(dim=d, num_subquantizers=4, nbits=4, device=dev).train(data[:256], n_iters=5)
    packed4 = shard_rows(pack_codes_4bit(pq4.encode(data)), mesh)
    p4d, p4i = sharded_pq_scan(packed4, pq4.adc_tables(queries), n, mesh, k=5, tile_size=128, rerank=8,
                               vectors=vec_shard, queries=queries, packed_4bit=True)
    _check(bool(torch.isfinite(p4d).all()) and bool((p4i < n).all()), "sharded 4-bit PQ scan")
    return {
        "mesh": (axis_size(mesh, "data"), axis_size(mesh, MODEL_AXIS)),
        "search_labels": res.labels.cpu().numpy(),
        "exact_ids": ei.cpu().numpy(),
        "big_shard_rows": gb.vectors.shape[0],
    }


__all__ = ["dryrun_multichip", "run_cases", "run_meshes"]
