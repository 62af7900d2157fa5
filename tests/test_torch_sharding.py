"""The port's sharded graph search, data-parallel search and mesh build
(flatnav_tpu_torch.parallel) on gloo ranks on the CPU.

Each mesh shape, (1, 4), (2, 2) and (4, 1), gets one spawn of four ranks
that runs every case (`parallel.dryrun.run_cases`); the tests assert on its
arrays. They hold:

  * against the single-device port: labels, build links, vectors and labels
    exactly, distances within 1e-5, counters equal;
  * against flatnav_tpu's sharded functions on the same shapes of the
    8-device virtual CPU mesh: >= 99% of result rows identical on float
    tables (the entry scan's matmul rounds differently), every row on the
    8-bit table, and the built graph exactly.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flatnav_tpu.index as jindex
from flatnav_tpu.index.build import add_batch as jax_add_batch
from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.parallel import data_parallel_search as jax_dp_search
from flatnav_tpu.parallel import make_mesh as jax_make_mesh
from flatnav_tpu.parallel import sharded_search as jax_sharded_search
from flatnav_tpu_torch.data_type import to_numpy
from flatnav_tpu_torch.index import build as build_mod
from flatnav_tpu_torch.index.build import _safe_wave_size, add_batch
from flatnav_tpu_torch.index.graph import graph_from_numpy, make_empty_graph
from flatnav_tpu_torch.index.search import _search_temp_bytes, batched_search
from flatnav_tpu_torch.ops import MetricType
from flatnav_tpu_torch.parallel import run_ranks
from flatnav_tpu_torch.parallel.dryrun import run_cases
from flatnav_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS, shard_rows
from tests.test_search import build_knn_graph

SHAPES = [(1, 4), (2, 2), (4, 1)]
K, EF = 5, 32
BUILD_N, BUILD_D, BUILD_M, BUILD_EFC = 1000, 16, 8, 32
#: the mesh shapes the JAX package builds on, per table layout (a layout is
#: trivial on the others: one shard, or one lane slice)
JAX_BUILDS = {(1, 4): ("model",), (2, 2): ("model", "replicated"), (4, 1): ("replicated",)}


def _graph_dict(g):
    return {"vectors": to_numpy(g.vectors), "links": to_numpy(g.links),
            "labels": to_numpy(g.labels), "num_nodes": g.num_nodes, "capacity": g.capacity}


def _search_limit(table_bytes: int) -> int:
    """A device size at which the guard splits a dispatch to about 4
    queries a rank."""
    return int(table_bytes + _search_temp_bytes(4, EF, 1, 8, 24) / 0.85 * 1.05)


def _build_tables(n_model: int) -> int:
    """Table bytes one rank holds in the mesh build under "model"."""
    rows = BUILD_N + 1024  # capacity + wave_pad
    n_local = -(-rows // n_model)
    return n_local * (BUILD_D * 4 + BUILD_M * 4)


@pytest.fixture(scope="module")
def wave_limit():
    """A device size at which the wave guard picks 256 lanes for a quarter
    of the build's table and 128 for half of it or the whole (a table
    sized by the mesh's 4 ranks would take 256 on the (2, 2) mesh)."""
    full = (BUILD_N + 1024) * BUILD_D * 4 + (BUILD_N + 1025) * BUILD_M * 4
    kw = dict(ef_construction=BUILD_EFC, m=BUILD_M, d=BUILD_D, expand_factor=32,
              intra_candidates=8, device="cuda")
    saved = build_mod._device_mem_limit

    def widths(limit):
        build_mod._device_mem_limit = lambda device: limit
        try:
            return [_safe_wave_size(8192, table_bytes=t, **kw)
                    for t in (_build_tables(4), _build_tables(2), full)]
        finally:
            build_mod._device_mem_limit = saved

    lo, hi = 1, 1 << 34  # smallest limit at which a quarter table takes 256 lanes
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if widths(mid)[0] >= 256 else (mid, hi)
    assert widths(hi) == [256, 128, 128]
    return hi


@pytest.fixture(scope="module")
def inputs(wave_limit):
    rng = np.random.default_rng(0xBEEF)
    n, d, m = 960, 24, 8
    data = rng.standard_normal((n, d), dtype=np.float32)
    queries = rng.standard_normal((64, d), dtype=np.float32)
    links = build_knn_graph(data, m, JMetric.L2)
    n_part = 700  # a committed prefix that ends inside a shard
    links_part = build_knn_graph(data[:n_part], m, JMetric.L2)
    data8 = rng.integers(0, 256, (480, 16)).astype(np.uint8)
    links8 = build_knn_graph(data8.astype(np.float32), m, JMetric.L2)
    queries8 = rng.integers(0, 256, (64, 16)).astype(np.uint8)
    build_data = np.random.default_rng(9).standard_normal((BUILD_N, BUILD_D), dtype=np.float32)

    port = {
        "full": graph_from_numpy(data, links, device="cpu"),
        "part": graph_from_numpy(data[:n_part], links_part, capacity=n, device="cpu"),
        "u8": graph_from_numpy(data8, links8, device="cpu"),
    }
    jax_graphs = {
        "full": jindex.graph_from_numpy(data, links),
        "part": jindex.graph_from_numpy(data[:n_part], links_part, capacity=n),
        "u8": jindex.graph_from_numpy(data8, links8),
    }
    g = port["full"]
    table = to_numpy(g.vectors).nbytes + to_numpy(g.links).nbytes + to_numpy(g.labels).nbytes
    limit = _search_limit(table)

    def search(graph, q, op="search", **kw):
        return {"op": op, "args": {"graph": _graph_dict(port[graph]), "queries": q, "k": K, "ef": EF, **kw}}

    build_args = {"data": build_data, "capacity": BUILD_N, "max_edges": BUILD_M,
                  "ef_construction": BUILD_EFC, "metric": MetricType.L2}
    cases = {
        "l2": search("full", queries),
        "ip": search("full", queries, metric=MetricType.IP),
        "e4": search("full", queries, expand_factor=4),
        "part": search("part", queries),
        "u8": search("u8", queries8),
        "chunked": {**search("full", queries), "mem_limit": limit},
        "dp": search("full", queries, op="dp_search"),
        "dp_ip": search("full", queries, op="dp_search", metric=MetricType.IP),
        "dp_chunked": {**search("full", queries, op="dp_search"), "mem_limit": limit},
        "build_model": {"op": "build", "args": {**build_args, "table_spec": "model"}},
        "build_replicated": {"op": "build", "args": {**build_args, "table_spec": "replicated"}},
        "build_guarded": {"op": "build", "args": {**build_args, "table_spec": "model"},
                          "mem_limit": wave_limit},
    }
    return {"port": port, "jax": jax_graphs, "cases": cases, "queries": queries,
            "queries8": queries8, "build_data": build_data}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def shape(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(inputs, shape):
    """Every case's outputs from one spawn of four gloo ranks."""
    names = list(inputs["cases"])
    out = run_ranks(run_cases, 4, backend="gloo", device="cpu", timeout=300,
                    args=([inputs["cases"][n] for n in names], *shape, "cpu"))
    return dict(zip(names, out))


def _single(inputs, graph, q, **kw):
    g = inputs["port"][graph]
    return batched_search(g.vectors, g.links, g.labels, g.num_nodes, torch.from_numpy(q), k=K, ef=EF, **kw)


def _single_build(data, **kw):
    return add_batch(make_empty_graph(BUILD_N, BUILD_D, BUILD_M, device="cpu"), data, np.arange(BUILD_N),
                     ef_construction=BUILD_EFC, metric=MetricType.L2, **kw)


@pytest.fixture(scope="module")
def single(inputs):
    q, q8 = inputs["queries"], inputs["queries8"]
    stats = {}
    return {
        "l2": _single(inputs, "full", q),
        "ip": _single(inputs, "full", q, metric=MetricType.IP),
        "e4": _single(inputs, "full", q, expand_factor=4),
        "part": _single(inputs, "part", q),
        "u8": _single(inputs, "u8", q8),
        "build": _single_build(inputs["build_data"], stats=stats),
        "build_stats": (stats["distance_computations"], stats["hops"]),
    }


# ---- model-sharded search against the single-device port ------------------


@pytest.mark.parametrize("case", ["l2", "ip", "e4", "part", "u8"])
def test_sharded_search_labels_equal_single_device(ranks, single, case):
    np.testing.assert_array_equal(ranks[case]["labels"], single[case].labels.numpy())


@pytest.mark.parametrize("case", ["l2", "ip", "e4", "part", "u8"])
def test_sharded_search_dists_match_single_device(ranks, single, case):
    np.testing.assert_allclose(ranks[case]["dists"], single[case].dists.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["l2", "e4"])
def test_sharded_search_counters_equal_single_device(ranks, single, case):
    assert ranks[case]["dist_computations"] == single[case].dist_computations
    assert ranks[case]["hops"] == single[case].hops


def test_sharded_search_partial_prefix_stays_committed(ranks):
    labels = ranks["part"]["labels"]
    assert (labels >= 0).all() and (labels < 700).all()


def test_sharded_search_chunks_under_the_memory_guard(ranks, single):
    np.testing.assert_array_equal(ranks["chunked"]["labels"], single["l2"].labels.numpy())
    np.testing.assert_allclose(ranks["chunked"]["dists"], single["l2"].dists.numpy(), rtol=0, atol=1e-5)


# ---- data-parallel search ---------------------------------------------------


@pytest.mark.parametrize("case,ref", [("dp", "l2"), ("dp_ip", "ip"), ("dp_chunked", "l2")])
def test_data_parallel_search_equals_single_device(ranks, single, case, ref):
    np.testing.assert_array_equal(ranks[case]["labels"], single[ref].labels.numpy())
    np.testing.assert_allclose(ranks[case]["dists"], single[ref].dists.numpy(), rtol=0, atol=1e-5)
    assert ranks[case]["dist_computations"] == single[ref].dist_computations


def test_sharded_search_launch_counts_per_rank(ranks):
    # the plain versions run on the CPU, so no rank launches a kernel; every
    # rank reports its row
    assert ranks["l2"]["launches"].shape == (4, 2)
    assert (ranks["l2"]["launches"] == 0).all()


# ---- the mesh build ----------------------------------------------------------


@pytest.mark.parametrize("spec", ["model", "replicated"])
@pytest.mark.parametrize("name", ["links", "vectors", "labels"])
def test_mesh_build_equals_single_device(ranks, single, spec, name):
    got = ranks[f"build_{spec}"]
    rows = got[name].shape[0]
    np.testing.assert_array_equal(got[name], to_numpy(getattr(single["build"], name))[:rows])
    assert got["num_nodes"] == BUILD_N


@pytest.mark.parametrize("spec", ["model", "replicated"])
def test_mesh_build_counters_equal_single_device(ranks, single, spec):
    got = ranks[f"build_{spec}"]
    assert (got["distance_computations"], got["hops"]) == single["build_stats"]


def test_model_build_holds_a_shard_of_the_rows(ranks, shape):
    rows = BUILD_N + 1024
    assert ranks["build_model"]["shard_rows"] == -(-rows // shape[1])


@pytest.fixture(scope="module")
def single_by_wave(inputs):
    """Single-device builds at the two wave widths the guard can pick."""
    return {w: to_numpy(_single_build(inputs["build_data"], max_wave=w).links) for w in (128, 256)}


def test_wave_guard_counts_the_rows_a_rank_holds(ranks, single_by_wave, shape):
    # under the same device size the guard picks the width of 1/n_model of
    # the table: 256 lanes on (1, 4), 128 on (2, 2) (1/4, the mesh's ranks,
    # would give 256) and on (4, 1). The graph is the single device's at
    # that width and not at the other
    width = {4: 256, 2: 128, 1: 128}[shape[1]]
    got = ranks["build_guarded"]["links"]
    for max_wave, links in single_by_wave.items():
        assert np.array_equal(got, links[: got.shape[0]]) == (max_wave == width)


# ---- against flatnav_tpu's sharded functions ---------------------------------


def _jax_mesh(shape):
    return jax_make_mesh(n_devices=4, data=shape[0], model=shape[1])


#: the cases each mesh shape holds against the JAX package (its compiles
#: dominate this file's time, so each case runs where it is not trivial:
#: the prefix ends inside a shard on (1, 4), the data axis splits on the
#: others)
JAX_SEARCHES = {(1, 4): ("l2", "part", "u8"), (2, 2): ("ip", "dp"), (4, 1): ("dp",)}


@pytest.fixture(scope="module")
def jax_search(inputs, shape):
    mesh = _jax_mesh(shape)
    g = inputs["jax"]
    q, q8 = jnp.asarray(inputs["queries"]), jnp.asarray(inputs["queries8"])
    calls = {
        "l2": lambda: jax_sharded_search(g["full"], q, mesh, k=K, ef=EF),
        "ip": lambda: jax_sharded_search(g["full"], q, mesh, k=K, ef=EF, metric=JMetric.IP),
        "part": lambda: jax_sharded_search(g["part"], q, mesh, k=K, ef=EF),
        "u8": lambda: jax_sharded_search(g["u8"], q8, mesh, k=K, ef=EF),
        "dp": lambda: jax_dp_search(g["full"], q, mesh, k=K, ef=EF),
    }
    return {case: calls[case]() for case in JAX_SEARCHES[shape]}


def test_search_rows_match_jax_sharded(ranks, jax_search):
    for case, want in jax_search.items():
        got = ranks[case]
        if case == "u8":  # exact integer distances: every row
            np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
            np.testing.assert_array_equal(got["dists"], np.asarray(want.dists))
            continue
        same = (got["labels"] == np.asarray(want.labels)).all(axis=1)
        assert same.mean() >= 0.99, case
        np.testing.assert_allclose(got["dists"][same], np.asarray(want.dists)[same], rtol=1e-5, atol=1e-5)


def test_mesh_build_equals_jax_sharded(ranks, inputs, shape):
    from flatnav_tpu.index.graph import make_empty_graph as jax_empty

    for spec in JAX_BUILDS[shape]:
        g = jax_add_batch(jax_empty(BUILD_N, BUILD_D, BUILD_M), inputs["build_data"], np.arange(BUILD_N),
                          ef_construction=BUILD_EFC, metric=JMetric.L2, mesh=_jax_mesh(shape),
                          table_spec=spec)
        got = ranks[f"build_{spec}"]
        np.testing.assert_array_equal(got["links"][:BUILD_N], np.asarray(g.links)[:BUILD_N])
        np.testing.assert_array_equal(got["vectors"][:BUILD_N], np.asarray(g.vectors)[:BUILD_N])


# ---- guards --------------------------------------------------------------------


def test_collective_mismatch_raises_within_the_timeout():
    import time

    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        run_ranks(run_cases, 4, backend="gloo", device="cpu", timeout=8,
                  args=([{"op": "mismatch"}], 2, 2, "cpu"))
    assert time.monotonic() - t0 < 40


def test_parallel_package_imports_no_jax():
    code = ("import sys, flatnav_tpu_torch.parallel, flatnav_tpu_torch.parallel.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flatnav_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


class _Mesh:
    """The two DeviceMesh methods `shard_rows` reads, for one coordinate."""

    mesh_dim_names = (DATA_AXIS, MODEL_AXIS)
    device_type = "cpu"

    def __init__(self, n_model, index):
        self.n_model, self.index = n_model, index

    def size(self, dim):
        return (1, self.n_model)[dim]

    def get_local_rank(self, name):
        return 0 if name == DATA_AXIS else self.index


@pytest.mark.parametrize("n_model", [1, 3, 4])
def test_shard_rows_pads_like_the_jax_build(n_model):
    # rows pad to divide by the model axis: zeros for vectors, a padding row
    # of links holds its own id (flatnav_tpu/index/build.py:610-623)
    vec = torch.arange(10 * 2, dtype=torch.float32).reshape(10, 2)
    links = torch.arange(10, dtype=torch.int32)[:, None].expand(10, 3) + 100
    pad = (-10) % n_model
    want_vec = torch.cat([vec, torch.zeros(pad, 2)])
    want_links = torch.cat([links, torch.arange(10, 10 + pad, dtype=torch.int32)[:, None].expand(pad, 3)])
    parts_v = [shard_rows(vec, _Mesh(n_model, i)) for i in range(n_model)]
    parts_l = [shard_rows(links, _Mesh(n_model, i), self_loop=True) for i in range(n_model)]
    assert len({p.shape[0] for p in parts_v}) == 1
    assert torch.equal(torch.cat(parts_v), want_vec)
    assert torch.equal(torch.cat(parts_l), want_links)


def test_parallel_package_has_every_public_name_of_the_jax_one():
    import flatnav_tpu.parallel as jax_parallel
    import flatnav_tpu_torch.parallel as port_parallel

    names = [n for n in dir(jax_parallel) if not n.startswith("_")
             and not isinstance(getattr(jax_parallel, n), type(jax_parallel))]
    assert names and all(hasattr(port_parallel, n) for n in names), names
