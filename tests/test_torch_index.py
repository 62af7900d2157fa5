"""The port's Index lifecycle (flatnav_tpu_torch.index) against flatnav_tpu,
on the CPU: create -> add -> search / search_exact -> save / load.

The beam search is held to the JAX package on the identical graph (a
JAX-built index carried across with `convert`): every hop scores with the
same fixed-order tree sums, so the only expected source of a difference is
the entry scan's matmul rounding, which can pick another entry point on a
near tie. Graphs built by the two packages are held to recall within 0.02.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu
import flatnav_tpu_torch
from flatnav_tpu_torch import convert
from flatnav_tpu_torch.data_type import DataType
from flatnav_tpu_torch.index import batched_search
from flatnav_tpu_torch.index.build import add_batch
from flatnav_tpu_torch.index.graph import make_empty_graph
from flatnav_tpu_torch.ops import MetricType, brute_force_knn

N, D, M, EFC, K, EF = 2000, 32, 16, 100, 10, 128


def _recall(found, truth):
    return sum(len(set(f) & set(t)) for f, t in zip(found, truth)) / truth.size


@pytest.fixture(scope="module")
def built():
    """Same data and insertion order through both packages."""
    rng = np.random.default_rng(0xF1A7)
    data = rng.standard_normal((N, D), dtype=np.float32)
    queries = rng.standard_normal((50, D), dtype=np.float32)
    jx = flatnav_tpu.index.create("l2", dim=D, dataset_size=N, max_edges_per_node=M)
    jx.add(data, ef_construction=EFC)
    px = flatnav_tpu_torch.index.create(
        "l2", dim=D, dataset_size=N, max_edges_per_node=M, device="cpu"
    )
    px.add(data, ef_construction=EFC)
    _, truth = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), K)
    return data, queries, jx, px, truth.numpy()


def test_jax_built_graph_searched_by_both(built, tmp_path):
    _, queries, jx, _, _ = built
    path = str(tmp_path / "jax.npz")
    jx.save(path)
    px = convert.index_from_jax_npz(path, device="cpu")
    jd, jl = jx.search(queries, K=K, ef_search=EF)
    pd, pl = px.search(queries, K=K, ef_search=EF)
    same = (pl == jl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(pd[same], jd[same], rtol=1e-6)


def test_graph_from_jax_arrays_is_bit_for_bit(built):
    _, queries, jx, _, _ = built
    g = jx.graph
    pg = convert.graph_from_jax_arrays(
        np.asarray(g.vectors), np.asarray(g.links), np.asarray(g.labels),
        int(g.num_nodes), g.capacity, device="cpu",
    )
    np.testing.assert_array_equal(pg.links.numpy(), np.asarray(g.links))
    np.testing.assert_array_equal(pg.vectors.numpy(), np.asarray(g.vectors))
    res = batched_search(pg.vectors, pg.links, pg.labels, pg.num_nodes,
                         torch.from_numpy(queries), k=K, ef=EF, expand_factor=16)
    _, jl = jx.search(queries, K=K, ef_search=EF)
    assert (res.labels.numpy() == jl).all(axis=1).mean() >= 0.99
    with pytest.raises(ValueError, match="padded layout"):
        convert.graph_from_jax_arrays(
            np.asarray(g.vectors)[:N], np.asarray(g.links), np.asarray(g.labels),
            N, g.capacity, device="cpu",
        )


def test_port_built_graph_recall_matches_jax(built):
    _, queries, jx, px, truth = built
    _, jl = jx.search(queries, K=K, ef_search=EF)
    _, pl = px.search(queries, K=K, ef_search=EF)
    assert px.num_nodes == jx.num_nodes == N
    assert abs(_recall(pl, truth) - _recall(jl, truth)) <= 0.02
    assert _recall(pl, truth) >= 0.95
    # every prune decision rests on distances both packages compute alike,
    # so the graphs themselves come out (nearly) identical
    same_rows = (px.graph.links[:N].numpy() == np.asarray(jx.graph.links[:N])).all(1)
    assert same_rows.mean() >= 0.95


def test_port_build_bit_deterministic():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((1500, 16), dtype=np.float32)

    def build():
        g = make_empty_graph(1500, 16, 8, device="cpu")
        return add_batch(g, data, np.arange(1500), ef_construction=48,
                         metric=MetricType.L2, max_wave=512)

    g1, g2 = build(), build()
    assert torch.equal(g1.links, g2.links)
    assert torch.equal(g1.vectors, g2.vectors)
    assert torch.equal(g1.labels, g2.labels)


@pytest.mark.parametrize("dtype", [DataType.float32, DataType.bfloat16, DataType.uint8])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_round_trip_between_packages(tmp_path, dtype, direction):
    rng = np.random.default_rng(3)
    n, d = 300, 8
    if dtype == DataType.uint8:
        data = rng.integers(0, 256, (n, d)).astype(np.uint8)
    else:
        data = rng.standard_normal((n, d)).astype(np.float32)
    jdt = flatnav_tpu.data_type.DataType(dtype.value)
    jx = flatnav_tpu.index.create("angular", d, 400, 8, index_data_type=jdt)
    px = flatnav_tpu_torch.index.create("angular", d, 400, 8, index_data_type=dtype,
                                        device="cpu")
    path = str(tmp_path / "ix.npz")
    if direction == "jax_to_port":
        jx.add(data, ef_construction=32)
        jx.save(path)
        src, dst = jx, flatnav_tpu_torch.index.load_index(path, device="cpu")
    else:
        px.add(data, ef_construction=32)
        px.save(path)
        src, dst = px, flatnav_tpu.index.load_index(path)
    assert dst.num_nodes == src.num_nodes == n
    assert dst.capacity == 400 and dst.data_type.value == dtype.value
    assert dst.metric.value == "ip"

    def arrays(ix):
        g = ix.graph
        if isinstance(g.vectors, torch.Tensor):
            v = g.vectors.float().numpy()
            return v, g.links.numpy(), g.labels.numpy()
        return (np.asarray(g.vectors).astype(np.float32), np.asarray(g.links),
                np.asarray(g.labels))

    for a, b in zip(arrays(src), arrays(dst)):  # the committed rows
        np.testing.assert_array_equal(a[:n], b[:n])
    assert src.get_graph_outdegree_table() == dst.get_graph_outdegree_table()


def test_search_exact_engines_match_jax(built):
    data, queries, jx, px, truth = built
    for kw in (dict(), dict(rerank=32), dict(rerank=32, fused=False)):
        jd, jl = jx.search_exact(queries, K=K, **kw)
        pd, pl = px.search_exact(queries, K=K, **kw)
        assert (pl == jl).mean() >= 0.99, kw
        np.testing.assert_allclose(pd[pl == jl], jd[pl == jl], rtol=1e-5)
    _, pl = px.search_exact(queries, K=K)
    assert _recall(pl, truth) == 1.0
    _, pl = px.search_exact(queries, K=K, rerank=32, exact_rerank=False)
    assert _recall(pl, truth) >= 0.97


@pytest.fixture(scope="module")
def built_u8(tmp_path_factory):
    """A uint8 index built by the port and loaded by both packages."""
    rng = np.random.default_rng(0xB8)
    data = rng.integers(0, 256, (600, 37)).astype(np.uint8)
    queries = rng.integers(0, 256, (8, 37)).astype(np.uint8)
    px = flatnav_tpu_torch.index.create(
        "l2", 37, 600, 8, index_data_type=DataType.uint8, device="cpu"
    )
    px.add(data, ef_construction=32)
    path = str(tmp_path_factory.mktemp("u8") / "u8.npz")
    px.save(path)
    return queries, flatnav_tpu.index.load_index(path), px


@pytest.mark.parametrize("kw", [
    {}, {"rerank": 32}, {"rerank": 32, "fused": False},
    {"rerank": 32, "exact_rerank": False},
])
def test_8bit_search_exact_engines_identical_to_jax(built_u8, kw):
    # 8-bit keys and distances are exact integers in both packages
    queries, jx, px = built_u8
    jd, jl = jx.search_exact(queries, K=5, **kw)
    pd, pl = px.search_exact(queries, K=5, **kw)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pd, jd)


def test_info_and_counters_match_jax(built):
    data, queries, jx, px, _ = built
    assert px.index_memory_bytes() == jx.index_memory_bytes()
    assert px.get_graph_outdegree_table()[0] != []
    ix = flatnav_tpu_torch.index.create("l2", D, N, M, collect_stats=True, device="cpu")
    ix.add(data[:500], ef_construction=32)
    assert ix.get_build_stats()["distance_computations"] > 0
    ix.search(queries, K=K, ef_search=32)
    assert ix.get_query_distance_computations() > 0
    assert ix.get_query_distance_computations() == 0  # read-and-reset
    d1, l1 = ix.search_single(queries[0], K=K, ef_search=32)
    d2, l2 = ix.search(queries[:1], K=K, ef_search=32)
    np.testing.assert_array_equal(l1, l2[0])
    for setter in (ix.set_num_threads, ix.set_query_batch_size, ix.set_expand_factor):
        with pytest.raises(ValueError):
            setter(0)


def _error(fn):
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case", [
    "distance_type", "zero_dim", "add_dims", "add_num_init", "add_labels",
    "capacity", "search_dims", "search_num_init", "exact_rerank",
])
def test_validation_errors_match_jax(case):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((40, 8), dtype=np.float32)

    def run(pkg, **kw):
        create = pkg.index.create
        if case == "distance_type":
            return lambda: create("cosine", 8, 50, 4, **kw)
        if case == "zero_dim":
            return lambda: create("l2", 0, 50, 4, **kw)
        ix = create("l2", 8, 50, 4, **kw)
        return {
            "add_dims": lambda: ix.add(data[:, :5], ef_construction=16),
            "add_num_init": lambda: ix.add(data, 16, num_initializations=0),
            "add_labels": lambda: ix.add(data, 16, labels=[1, 2]),
            "capacity": lambda: ix.add(np.concatenate([data, data]), 16),
            "search_dims": lambda: ix.search(data[:, :5], K=3, ef_search=8),
            "search_num_init": lambda: ix.search(data, 3, 8, num_initializations=0),
            "exact_rerank": lambda: ix.search_exact(data, 3, exact_rerank=False),
        }[case]

    assert _error(run(flatnav_tpu_torch, device="cpu")) == _error(run(flatnav_tpu))


def test_cuda_is_the_default_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flatnav_tpu_torch.index.create("l2", 8, 10, 4)
    ix = flatnav_tpu_torch.index.create("l2", 8, 10, 4, device="cpu")
    ix.add(np.ones((3, 8), np.float32), ef_construction=8)
    ix.save(str(tmp_path / "a.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flatnav_tpu_torch.index.load_index(str(tmp_path / "a.npz"))
    assert flatnav_tpu_torch.index.load_index(
        str(tmp_path / "a.npz"), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("method", ["allocate_nodes", "build_graph_links", "reorder"])
def test_unported_members_raise(method, tmp_path):
    # the last three Index members to be ported: none is left that raises
    # NotImplementedError (tests/test_torch_reorder.py holds them to the
    # JAX package)
    ix = flatnav_tpu_torch.index.create("l2", 8, 10, 4, device="cpu")
    ix.add(np.eye(8, dtype=np.float32)[:5], ef_construction=8)
    mtx = tmp_path / "g.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate pattern general\n6 6 1\n1 2\n")
    call = {
        "allocate_nodes": lambda: ix.allocate_nodes(np.zeros((1, 8), np.float32)),
        "build_graph_links": lambda: (ix.allocate_nodes(np.zeros((1, 8), np.float32)),
                                      ix.build_graph_links(str(mtx))),
        "reorder": lambda: ix.reorder(["gorder", "rcm"]),
    }[method]
    call()
    assert ix.num_nodes == (5 if method == "reorder" else 6)
    with open(flatnav_tpu_torch.index.api.__file__) as f:
        assert "NotImplementedError" not in f.read()


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_add_and_search_take_read_only_arrays(tmp_path, monkeypatch, dtype):
    # ROADMAP C.3: a read-only array (a memory-mapped file, say) is copied,
    # not handed to torch.from_numpy, which warns that it is not writable
    # (once a process, so the spy below catches every such call)
    import warnings

    from_numpy = torch.from_numpy

    def writable_only(a):
        assert a.flags.writeable, "torch.from_numpy got a read-only array"
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", writable_only)
    rng = np.random.default_rng(3)
    path = tmp_path / "data.npy"
    np.save(path, (rng.standard_normal((300, 8)) * 40 + 100).clip(0, 255).astype(dtype))
    data = np.load(path, mmap_mode="r")
    assert not data.flags.writeable
    ix = flatnav_tpu_torch.index.create("l2", dim=8, dataset_size=600, max_edges_per_node=8,
                                        index_data_type=DataType(np.dtype(dtype).name), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ix.add(data, ef_construction=32)
        ix.allocate_nodes(data, labels=np.arange(300, 600, dtype=np.int32))
        _, labels = ix.search(data[:5], K=1, ef_search=32)
        ix.search_exact(data[:5], K=1)
    assert ix.num_nodes == 600 and labels[:, 0].tolist() == list(range(5))


def test_prune_counts_float64_for_8bit_rows():
    # ROADMAP C.4: the prune promotes 8-bit candidate rows to float64, so the
    # [W, C, C] product's 1 GiB rule counts 8 bytes an element for them
    from flatnav_tpu_torch.index.build import _precomputes, _prune_itemsize

    assert _prune_itemsize(torch.uint8) == _prune_itemsize(torch.int8) == 8
    assert _prune_itemsize(torch.float32) == _prune_itemsize(torch.bfloat16) == 4
    c = 256
    w = (1 << 30) // (c * c * 4)  # exactly 1 GiB at 4 bytes an element
    assert _precomputes(w, c, 4) and not _precomputes(w, c, 8)
    assert _precomputes(w // 2, c, 8)


def test_wave_guard_counts_float64_for_8bit_rows(monkeypatch):
    # ROADMAP C.4: _safe_wave_size charges the prune's candidate rows at the
    # element size it allocates; with a fixed card size an 8-bit build gets
    # a narrower wave than a float32 one where that term decides
    from flatnav_tpu_torch.index import build as build_mod

    monkeypatch.setattr(build_mod, "_device_mem_limit", lambda device: 6 << 30)
    kw = dict(ef_construction=200, m=32, d=960, expand_factor=32, intra_candidates=32,
              table_bytes=0, device="cuda")
    w4 = build_mod._safe_wave_size(8192, **kw, prune_itemsize=4)
    w8 = build_mod._safe_wave_size(8192, **kw, prune_itemsize=8)
    assert w8 < w4
    # add_batch passes the table's own element size
    seen = {}

    def spy(max_wave, **k):
        seen.update(k)
        return max_wave

    monkeypatch.setattr(build_mod, "_safe_wave_size", spy)
    for dtype, size in ((torch.uint8, 8), (torch.float32, 4)):
        g = make_empty_graph(64, 4, 4, dtype=dtype, device="cpu")
        add_batch(g, np.ones((8, 4), np.float32).astype(np.dtype(str(dtype)[6:])), np.arange(8),
                  ef_construction=8, metric=MetricType.L2)
        assert seen["prune_itemsize"] == size
