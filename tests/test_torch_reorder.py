"""The port's graph reordering and import path (flatnav_tpu_torch.reorder,
.native, Index.reorder / allocate_nodes / build_graph_links) against
flatnav_tpu, on the CPU.

Everything here is integer work, so every comparison is exact: permutations,
links, labels and vectors must be identical arrays, and error messages the
same strings.
"""

import importlib
import pathlib
import re
import shutil
import sys
import time

import numpy as np
import pytest
import torch

import flatnav_tpu
import flatnav_tpu.native as jax_native
import flatnav_tpu.reorder as jax_reorder
import flatnav_tpu_torch
from flatnav_tpu_torch import _build, convert, native, reorder
from flatnav_tpu_torch.index.api import Index, _read_mtx_python
from flatnav_tpu_torch.ops import MetricType

N, D, M = 600, 16, 8


def _random_links(rng, n=300, m=8):
    links = rng.integers(0, n, (n, m)).astype(np.int32)
    # sprinkle self-loop padding like a real index
    mask = rng.random((n, m)) < 0.2
    links[mask] = (np.arange(n)[:, None] * np.ones((1, m), int))[mask]
    return links


def _wait_for_settled_file(lib: pathlib.Path, src: pathlib.Path, timeout: float = 180.0) -> None:
    """Wait until `lib` exists, is not older than `src`, and has kept its
    size and mtime for a second: no build is rewriting it any more."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            now = (lib.stat().st_size, lib.stat().st_mtime_ns)
            if now == last:
                return
            last = now
        else:
            last = None
        time.sleep(1.0)


@pytest.fixture(scope="module")
def loaded_jax_native():
    """flatnav_tpu.native with its library loaded.

    That module builds libflatnav_native.so in place, from every process
    that imports it while the file is missing or older than its source; a
    process that loads the file while another rewrites it caches the failure
    (`_tried`) and takes its Python paths for good. So where the library is
    not loaded but a compiler exists, wait for the file to settle and reload
    the module, a few times, and fail if it still does not load. Only a
    machine without g++ skips, as tests/test_native.py does."""
    if jax_native.available():
        return jax_native
    if shutil.which("g++") is None:
        pytest.skip("no host compiler: flatnav_tpu.native has no library")
    lib = pathlib.Path(jax_native._LIB_PATH)
    src = lib.with_name("flatnav_native.cpp")
    for attempt in range(5):
        _wait_for_settled_file(lib, src)
        importlib.reload(jax_native)
        if jax_native.available():
            return jax_native
        time.sleep(1.0 + attempt)
    pytest.fail(f"flatnav_tpu.native did not load {lib} after {attempt + 1} reloads")


@pytest.fixture
def jax_python_path(monkeypatch):
    """flatnav_tpu.reorder with its native redirect switched off."""
    monkeypatch.setattr(jax_native, "gorder", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "rcm_order", lambda *a, **k: None)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    root = pathlib.Path(flatnav_tpu_torch.__file__).parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|flatnav_tpu)\b", re.M)
    sources = sorted(root.rglob("*.py"))
    assert len(sources) > 20
    for path in sources + [root.parent / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path


@pytest.mark.parametrize("window", [3, 5])
def test_gorder_python_paths_identical(rng, jax_python_path, window):
    links = _random_links(rng)
    want = jax_reorder.gorder(links, 300, window_size=window)
    got = reorder.gorder_python(links, 300, window_size=window)
    assert sorted(got.tolist()) == list(range(300))
    np.testing.assert_array_equal(got, want)


def test_rcm_python_paths_identical(rng, jax_python_path):
    links = _random_links(rng)
    want = jax_reorder.rcm_order(links, 300)
    got = reorder.rcm_order_python(links, 300)
    assert sorted(got.tolist()) == list(range(300))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ["gorder", "rcm"])
def test_public_entry_points_identical_to_jax(rng, algo):
    # whichever path each package takes here (native against native where
    # both libraries load)
    links = _random_links(rng, n=500, m=12)
    if algo == "gorder":
        got, want = reorder.gorder(links, 500), jax_reorder.gorder(links, 500)
    else:
        got, want = reorder.rcm_order(links, 500), jax_reorder.rcm_order(links, 500)
    np.testing.assert_array_equal(got, want)


def test_native_is_built_by_the_host_compiler():
    assert _build.host_compiler() is not None  # this machine has g++
    assert native.available()
    assert _build.target("flatnav_native").exists()
    assert "flatnav_native" not in _build.sources()  # host code is no CUDA kernel


@pytest.mark.parametrize("algo", ["gorder", "rcm"])
def test_native_matches_own_python_path(rng, algo):
    links = _random_links(rng)
    if algo == "gorder":
        got, want = native.gorder(links, 300, 5), reorder.gorder_python(links, 300, 5)
    else:
        got, want = native.rcm_order(links, 300), reorder.rcm_order_python(links, 300)
    assert sorted(got.tolist()) == list(range(300))
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The native module as at first use, building into an empty directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "OUT", tmp_path / "_build")


def test_failed_native_build_raises_with_compiler_output(fresh_native, monkeypatch):
    broken = [sys.executable, "-c", "import sys; print('boom: no such header'); sys.exit(1)"]
    monkeypatch.setattr(_build, "host_compiler", lambda: broken)
    with pytest.raises(RuntimeError, match="boom: no such header"):
        native.available()
    with pytest.raises(RuntimeError, match="flatnav_native"):  # and again: no silent fallback
        reorder.gorder(np.zeros((4, 2), np.int32), 4)


def test_python_paths_run_where_no_compiler_exists(fresh_native, monkeypatch, rng, tmp_path):
    monkeypatch.setattr(_build, "host_compiler", lambda: None)
    assert not native.available()
    links = _random_links(rng)
    np.testing.assert_array_equal(reorder.gorder(links, 300), reorder.gorder_python(links, 300))
    np.testing.assert_array_equal(reorder.rcm_order(links, 300), reorder.rcm_order_python(links, 300))
    assert native.read_mtx("x.mtx", 3, 2) is None and native.npy_read("x.npy") is None
    assert native.npy_write(str(tmp_path / "x.npy"), np.zeros((2, 2), np.float32)) is False
    assert not (tmp_path / "_build").exists()


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int8, np.int32])
def test_native_npy_roundtrip(tmp_path, rng, dtype, loaded_jax_native):
    arr = (rng.standard_normal((50, 7)) * 40).astype(dtype)
    ours = str(tmp_path / "ours.npy")
    assert native.npy_write(ours, arr)
    np.testing.assert_array_equal(np.load(ours), arr)  # numpy reads ours
    np.testing.assert_array_equal(loaded_jax_native.npy_read(ours), arr)  # and so does the JAX package
    theirs = str(tmp_path / "theirs.npy")
    np.save(theirs, arr)
    np.testing.assert_array_equal(native.npy_read(theirs), arr)  # we read numpy's
    assert native.npy_write(ours, arr[:, 0])  # 1-D
    np.testing.assert_array_equal(np.load(ours).reshape(-1), arr[:, 0])


def test_native_npy_rejects_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="1-D/2-D"):
        native.npy_write(str(tmp_path / "x.npy"), np.zeros((2, 2, 2), np.float32))
    assert native.npy_write(str(tmp_path / "x.npy"), np.zeros((2, 2), np.float64)) is False
    assert native.npy_read(str(tmp_path / "missing.npy")) is None


def _write_mtx(path, n, edges, comment=True):
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        if comment:
            f.write("% a comment line\n")
        f.write(f"{n} {n} {len(edges)}\n")
        for a, b in edges:
            f.write(f"{a + 1} {b + 1}\n")


def test_read_mtx_native_python_and_jax_agree(tmp_path, loaded_jax_native):
    n, m = 10, 4
    edges = [(i, (i + 1) % n) for i in range(n)] + [(0, 5)] + [(2, j) for j in range(3, 9)]
    path = str(tmp_path / "g.mtx")
    _write_mtx(path, n, edges)
    links = native.read_mtx(path, n, m)
    assert (links[:, 0] == (np.arange(n) + 1) % n).all()
    assert links[0, 1] == 5
    assert links[3, 1] == 3  # self-loop padding
    assert links[2].tolist() == [3, 3, 4, 5]  # at most m edges a source
    np.testing.assert_array_equal(links, _read_mtx_python(path, n, m))
    np.testing.assert_array_equal(links, loaded_jax_native.read_mtx(path, n, m))


@pytest.fixture(scope="module")
def jax_index():
    rng = np.random.default_rng(0xF1A7)
    data = rng.standard_normal((N, D), dtype=np.float32)
    jx = flatnav_tpu.index.create("l2", dim=D, dataset_size=N + 100, max_edges_per_node=M)
    jx.add(data, ef_construction=32, labels=np.arange(N)[::-1] + 7)
    return data, jx


def _port_copy(jx) -> Index:
    """The port's Index over the JAX index's arrays."""
    g = jx.graph
    pg = convert.graph_from_jax_arrays(
        np.asarray(g.vectors), np.asarray(g.links), np.asarray(g.labels),
        int(g.num_nodes), g.capacity, device="cpu",
    )
    return Index(MetricType.L2, D, g.capacity, M, _graph=pg, device="cpu")


def _assert_same_arrays(px, jx):
    pg, jg = px.graph, jx.graph
    assert pg.num_nodes == int(jg.num_nodes)
    np.testing.assert_array_equal(pg.vectors.numpy(), np.asarray(jg.vectors))
    np.testing.assert_array_equal(pg.links.numpy(), np.asarray(jg.links))
    np.testing.assert_array_equal(pg.labels.numpy(), np.asarray(jg.labels))


@pytest.mark.parametrize("strategies", [["gorder"], ["rcm"], ["gorder", "rcm"], ["RCM", "Gorder"]])
def test_index_reorder_gives_the_jax_arrays(jax_index, strategies):
    data, jx = jax_index
    jx2 = flatnav_tpu.index.Index(
        jx.metric, D, jx.capacity, M, _graph=jx.graph
    )  # reorder replaces the graph: work on a second handle
    px = _port_copy(jx)
    old = [t.clone() for t in (px.graph.vectors, px.graph.links, px.graph.labels)]
    before = px.search_exact(data[:20], K=5)
    jx2.reorder(strategies)
    px.reorder(strategies)
    _assert_same_arrays(px, jx2)
    assert not np.array_equal(px.graph.links.numpy(), np.asarray(jx.graph.links))
    # the relabelled graph is the old graph under one permutation P of the
    # node ids: row P[i] holds node i's vector, label and (mapped) links
    g = px.graph
    perm = torch.empty(N, dtype=torch.long)
    perm[(N - 1) - (g.labels[:N].long() - 7)] = torch.arange(N)  # node i's label is N-1-i+7
    assert sorted(perm.tolist()) == list(range(N))
    assert torch.equal(g.vectors[perm], old[0][:N])
    assert torch.equal(g.labels[perm], old[2][:N])
    assert torch.equal(g.links[perm].long(), perm[old[1][:N].long()])
    assert torch.equal(g.links[N:], old[1][N:])  # padding rows untouched
    # so the exact engine answers alike (the graph search need not: its
    # entry candidates are rows at a fixed stride of node ids)
    after = px.search_exact(data[:20], K=5)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_allclose(after[0], before[0], rtol=1e-5)


@pytest.mark.parametrize("with_labels", [False, True])
def test_allocate_nodes_and_build_graph_links_give_the_jax_arrays(jax_index, tmp_path, with_labels):
    data, jx = jax_index
    links = np.asarray(jx.graph.links[:N])
    edges = [(i, int(v)) for i, row in enumerate(links) for v in row if v != i]
    path = str(tmp_path / "graph.mtx")
    _write_mtx(path, N, edges)
    labels = list(range(1000, 1000 + N)) if with_labels else None
    j2 = flatnav_tpu.index.create("l2", dim=D, dataset_size=N + 100, max_edges_per_node=M)
    p2 = flatnav_tpu_torch.index.create("l2", dim=D, dataset_size=N + 100,
                                        max_edges_per_node=M, device="cpu")
    assert p2.allocate_nodes(data[:400], labels and labels[:400]) is p2
    p2.allocate_nodes(data[400:], labels and labels[400:])
    j2.allocate_nodes(data[:400], labels and labels[:400]).allocate_nodes(
        data[400:], labels and labels[400:])
    p2.build_graph_links(path)
    j2.build_graph_links(path)
    _assert_same_arrays(p2, j2)
    # the imported graph is the graph it was written from
    np.testing.assert_array_equal(p2.graph.links[:N].numpy(), links)
    assert p2.get_graph_outdegree_table() == jx.get_graph_outdegree_table()


def test_build_graph_links_python_parser_matches_native(jax_index, tmp_path, monkeypatch):
    data, jx = jax_index
    links = np.asarray(jx.graph.links[:N])
    path = str(tmp_path / "graph.mtx")
    _write_mtx(path, N, [(i, int(v)) for i, row in enumerate(links) for v in row if v != i])
    p1 = flatnav_tpu_torch.index.create("l2", D, N, M, device="cpu").allocate_nodes(data)
    p2 = flatnav_tpu_torch.index.create("l2", D, N, M, device="cpu").allocate_nodes(data)
    p1.build_graph_links(path)
    monkeypatch.setattr(native, "read_mtx", lambda *a: None)
    p2.build_graph_links(path)
    assert torch.equal(p1.graph.links, p2.graph.links)


def _error(fn):
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case,message", [
    ("capacity", "Maximum number of nodes reached."),
    ("mtx_header", "Invalid MatrixMarket header"),
    ("mtx_dims", "Matrix dimensions 7x7 do not match index size 5"),
    ("strategy", "Invalid reordering method: hilbert"),
])
def test_import_and_reorder_errors_match_jax(tmp_path, case, message):
    data = np.ones((5, 4), np.float32)
    bad_header = tmp_path / "bad.mtx"
    bad_header.write_text("%MatrixMarket nope\n5 5 0\n")
    bad_dims = str(tmp_path / "dims.mtx")
    _write_mtx(bad_dims, 7, [(0, 1)])

    def run(pkg, **kw):
        ix = pkg.index.create("l2", 4, 8, 2, **kw).allocate_nodes(data)
        return {
            "capacity": lambda: ix.allocate_nodes(data),
            "mtx_header": lambda: ix.build_graph_links(str(bad_header)),
            "mtx_dims": lambda: ix.build_graph_links(bad_dims),
            "strategy": lambda: ix.reorder(["gorder", "hilbert"]),
        }[case]

    got = _error(run(flatnav_tpu_torch, device="cpu"))
    assert got == _error(run(flatnav_tpu))
    assert got[1] == message
