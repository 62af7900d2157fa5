"""The port's benchmark harness and CLIs (flatnav_tpu_torch.bench,
flatnav_tpu_torch.tools) against flatnav_tpu's, on the CPU.

Mirrors tests/test_bench_harness.py case for case: the same files, written
by numpy, go through both packages' loaders; the same MetricContext through
both metric registries; the same .npy triplet through both harnesses, with
the row keys equal, `index_size` equal, recall within 0.01 and
`distance_computations` within 2% of the JAX run's.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import flatnav_tpu
import flatnav_tpu.bench.data_loader as jloader
import flatnav_tpu.bench.metrics as jmetrics
import flatnav_tpu.bench.run_benchmark as jbench
import flatnav_tpu_torch
import flatnav_tpu_torch.bench.data_loader as ploader
import flatnav_tpu_torch.bench.metrics as pmetrics
import flatnav_tpu_torch.bench.run_benchmark as pbench
from flatnav_tpu.bench.plotting import pareto_frontier as j_pareto
from flatnav_tpu_torch.bench.plotting import pareto_frontier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def npy_triplet(tmp_path_factory):
    td = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(1)
    train = rng.standard_normal((1200, 16)).astype(np.float32)
    queries = rng.standard_normal((40, 16)).astype(np.float32)
    d = ((queries[:, None, :] - train[None]) ** 2).sum(-1)
    gtruth = np.argsort(d, axis=1)[:, :10].astype(np.int32)
    paths = {}
    for name, arr in [("train", train), ("queries", queries), ("gtruth", gtruth)]:
        p = td / f"{name}.npy"
        np.save(p, arr)
        paths[name] = str(p)
    return paths, td


def _write_vecs(path, arr):
    with open(path, "wb") as f:
        for row in arr:
            f.write(np.asarray([arr.shape[1]], np.int32).tobytes())
            f.write(row.tobytes())


def _write_bin(path, arr):
    with open(path, "wb") as f:
        f.write(np.asarray(arr.shape, np.int32).tobytes())
        f.write(arr.tobytes())


def _same_triplets(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [{}, {"limit": 100}, {"offset": 1100},
                                {"offset": 50, "limit": 7}])
def test_data_loader_npy(npy_triplet, kw):
    paths, _ = npy_triplet
    args = (paths["train"], paths["queries"], paths["gtruth"])
    got = ploader.get_data_loader(*args, **kw).load_data()
    _same_triplets(got, jloader.get_data_loader(*args, **kw).load_data())
    want_rows = kw.get("limit", 1200 - kw.get("offset", 0))
    assert got[0].shape == (want_rows, 16) and got[1].shape == (40, 16)


@pytest.mark.parametrize("ext,dtype", [(".fvecs", np.float32), (".bvecs", np.uint8)])
@pytest.mark.parametrize("kw", [{}, {"offset": 5, "limit": 8}, {"offset": 15}])
def test_data_loader_texmex(tmp_path, rng, ext, dtype, kw):
    if dtype == np.uint8:
        base = rng.integers(0, 255, (20, 12)).astype(np.uint8)
    else:
        base = rng.standard_normal((20, 12)).astype(np.float32)
    gt = rng.integers(0, 100, (6, 4)).astype(np.int32)
    train, gtp = str(tmp_path / f"x{ext}"), str(tmp_path / "gt.ivecs")
    _write_vecs(train, base)
    _write_vecs(gtp, gt)
    got = ploader.get_data_loader(train, train, gtp, **kw).load_data()
    _same_triplets(got, jloader.get_data_loader(train, train, gtp, **kw).load_data())
    lo = kw.get("offset", 0)
    np.testing.assert_array_equal(got[0], base[lo : lo + kw.get("limit", 20)])
    np.testing.assert_array_equal(got[1], base)  # queries are read whole
    np.testing.assert_array_equal(got[2], gt)
    # .ivecs resolves through the extension factory
    _, _, gt2 = ploader.get_data_loader(gtp, gtp, gtp).load_data()
    np.testing.assert_array_equal(gt2, gt)


@pytest.mark.parametrize("ext,dtype", [(".fbin", np.float32), (".u8bin", np.uint8),
                                       (".i8bin", np.int8)])
def test_data_loader_binary_formats(tmp_path, rng, ext, dtype):
    arr = (rng.standard_normal((50, 8)) * 40).astype(dtype)
    p = str(tmp_path / f"x{ext}")
    _write_bin(p, arr)
    gt_ids = rng.integers(0, 50, (6, 4)).astype(np.int32)
    gtp = str(tmp_path / "gt.bin")
    with open(gtp, "wb") as f:
        f.write(np.asarray(gt_ids.shape, np.int32).tobytes())
        f.write(gt_ids.tobytes())
        f.write(rng.standard_normal((6, 4)).astype(np.float32).tobytes())
    for kw in ({}, {"offset": 10, "limit": 5}, {"offset": 45}):
        got = ploader.get_data_loader(p, p, gtp, **kw).load_data()
        _same_triplets(got, jloader.get_data_loader(p, p, gtp, **kw).load_data())
        lo = kw.get("offset", 0)
        np.testing.assert_array_equal(got[0], arr[lo : lo + kw.get("limit", 50)])
        np.testing.assert_array_equal(got[2], gt_ids)
    with pytest.raises(ValueError, match="cannot infer"):
        ploader.get_data_loader("x.csv", "x.csv", "x.csv")


def test_recall_clamps_both_sides():
    truth = np.asarray([[1, 2]])
    found_good = np.asarray([[1, 2, 9, 9, 9]])
    found_bad = np.asarray([[9, 9, 9, 1, 2]])
    for mod in (pmetrics, jmetrics):
        assert mod.recall_at_k(found_good, truth) == 1.0
        assert mod.recall_at_k(found_bad, truth) == 0.0


def test_metric_registry_equals_jax(rng):
    names = ["recall", "qps", "latency_p50", "latency_p90", "latency_p95",
             "latency_p99", "latency_p999", "distance_computations",
             "index_size", "build_time"]
    assert set(names) <= set(pmetrics.metric_manager.available)
    assert pmetrics.metric_manager.available == jmetrics.metric_manager.available
    index = types.SimpleNamespace(index_memory_bytes=lambda: 123456)
    fields = dict(
        index=index,
        found_labels=rng.integers(0, 30, (50, 10)),
        ground_truth=rng.integers(0, 30, (50, 10)),
        latencies_s=rng.random(50) * 0.01,
        total_seconds=0.37, num_queries=50, distance_computations=98765,
        build_seconds=1.25,
    )
    got = pmetrics.metric_manager.compute(names, pmetrics.MetricContext(**fields))
    want = jmetrics.metric_manager.compute(names, jmetrics.MetricContext(**fields))
    assert got == want
    assert got["latency_p50"] <= got["latency_p99"] <= got["latency_p999"]


def test_pareto_frontier():
    pts = [(0.5, 100), (0.6, 90), (0.55, 120), (0.9, 10), (0.8, 50)]
    front = pareto_frontier(pts)
    assert front == j_pareto(pts)
    assert (0.55, 120) in front and (0.9, 10) in front and (0.8, 50) in front
    assert (0.5, 100) not in front  # dominated by (0.55, 120)


def _bench_args(paths, td, tag, index_type, ef_search, **extra):
    argv = [
        "--dataset", paths["train"], "--queries", paths["queries"],
        "--gtruth", paths["gtruth"], "--metric", "l2",
        "--index-type", index_type, "--num-node-links", "8",
        "--ef-construction", "32", "--ef-search", *map(str, ef_search),
        "--k", "10", "--batch-size", "64",
        "--metrics-file", str(td / f"metrics_{tag}_{index_type}.json"), "--no-plot",
    ]
    for key, val in extra.items():
        argv += [f"--{key}", val]
    return argv


@pytest.mark.parametrize("index_type,ef_search,min_recall", [
    ("flatnav", (32, 64), 0.5),
    ("flatnav-exact", (32,), 0.99),
    ("flatnav-fast", (32,), 0.99),
    ("flatnav-fused", (32,), 0.99),
    ("flatnav-pq-scan", (32,), 0.9),
])
def test_run_benchmark_matches_jax(npy_triplet, index_type, ef_search, min_recall):
    paths, td = npy_triplet
    jrows = jbench.run_experiment(jbench.parse_args(
        _bench_args(paths, td, "jax", index_type, ef_search)))
    prows = pbench.main(
        _bench_args(paths, td, "port", index_type, ef_search, device="cpu"))
    assert len(prows) == len(jrows) == len(ef_search)
    for prow, jrow in zip(prows, jrows):
        assert set(prow) == set(jrow)
        assert prow["index_size"] == jrow["index_size"] > 0
        assert abs(prow["recall"] - jrow["recall"]) <= 0.01
        assert prow["recall"] >= min_recall
        assert prow["qps"] > 0 and prow["build_time"] >= 0
        assert abs(prow["distance_computations"] - jrow["distance_computations"]) <= (
            0.02 * jrow["distance_computations"])
        assert prow["distance_computations"] > 100
        assert prow["latency_p50"] <= prow["latency_p99"] <= prow["latency_p999"]
        for key in ("dataset", "index_type", "M", "ef_construction", "ef_search", "k"):
            assert prow[key] == jrow[key]
    with open(td / f"metrics_port_{index_type}.json") as f:
        assert len(json.load(f)) == len(ef_search)
    # higher ef must not reduce recall
    assert prows[-1]["recall"] >= prows[0]["recall"] - 1e-6


def test_run_benchmark_fusednr_reorder_and_memory_log(npy_triplet):
    paths, td = npy_triplet
    rows = pbench.main(_bench_args(paths, td, "port", "flatnav-fusednr", (32,), device="cpu"))
    assert rows[0]["recall"] >= 0.97
    log = td / "mem.jsonl"
    argv = _bench_args(paths, td, "port_reorder", "flatnav", (48,), device="cpu")
    rows = pbench.main(argv + ["--reordering-strategies", "gorder", "rcm",
                               "--memory-log", str(log)])
    assert rows[0]["recall"] > 0.5
    samples = [json.loads(line) for line in log.read_text().splitlines()]
    assert samples and samples[0]["host"]["vmrss_kb"] > 0


def test_run_benchmark_needs_a_card_by_default(npy_triplet, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths, td = npy_triplet
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pbench.main(_bench_args(paths, td, "nocard", "flatnav-exact", (32,)))


class _FakeHnsw:
    """hnswlib's knn_query / set_ef surface with brute-force answers."""

    def __init__(self, space, dim):
        self.dim = dim
        self._dc = 0

    def init_index(self, max_elements, ef_construction, M):
        pass

    def set_num_threads(self, n):
        pass

    def add_items(self, data, ids):
        self._data = np.asarray(data)
        self._ids = np.asarray(ids)

    def set_ef(self, ef):
        self._ef = ef

    def knn_query(self, q, k):
        d = ((np.asarray(q)[:, None, :] - self._data[None]) ** 2).sum(-1)
        self._dc += d.size
        idx = np.argsort(d, axis=1)[:, :k]
        return self._ids[idx], np.take_along_axis(d, idx, axis=1)

    def get_distance_computations(self):
        dc, self._dc = self._dc, 0
        return dc


def test_run_benchmark_hnsw_baseline(npy_triplet, monkeypatch):
    """--index-type hnsw drives the adapter end to end over a stand-in
    module; without hnswlib it raises a clear ImportError."""
    paths, td = npy_triplet
    argv = _bench_args(paths, td, "port", "hnsw", (32,), device="cpu")
    monkeypatch.setitem(sys.modules, "hnswlib", None)  # import raises ImportError
    with pytest.raises(ImportError, match="hnswlib"):
        pbench.main(argv)
    fake = types.ModuleType("hnswlib")
    fake.Index = _FakeHnsw
    monkeypatch.setitem(sys.modules, "hnswlib", fake)
    rows = pbench.main(argv)
    jrows = jbench.run_experiment(jbench.parse_args(
        _bench_args(paths, td, "jax", "hnsw", (32,))))
    assert len(rows) == 1 and set(rows[0]) == set(jrows[0])
    assert rows[0]["recall"] == 1.0  # the stand-in is exact brute force
    assert rows[0]["distance_computations"] == jrows[0]["distance_computations"] > 0
    assert rows[0]["index_size"] == jrows[0]["index_size"] > 0


def test_plot_failure_other_than_a_missing_matplotlib_is_not_swallowed(
        npy_triplet, monkeypatch):
    import flatnav_tpu_torch.bench.plotting as plotting

    paths, td = npy_triplet
    argv = _bench_args(paths, td, "plot", "flatnav-exact", (32,), device="cpu")
    argv.remove("--no-plot")

    def missing(*a, **kw):
        raise ImportError("no matplotlib")

    monkeypatch.setattr(plotting, "plot_pareto", missing)
    assert len(pbench.main(argv)) == 1

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(plotting, "plot_pareto", broken)
    with pytest.raises(OSError, match="disk full"):
        pbench.main(argv)


def _run(argv, **kw):
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                          timeout=600, cwd=REPO, **kw)


def test_cli_construct_query(npy_triplet):
    paths, td = npy_triplet
    index_path = str(td / "cli_index.npz")
    r = _run(["-m", "flatnav_tpu_torch.tools.construct", "0", paths["train"], "8", "32",
              index_path, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "saved index" in r.stdout
    # the saved index loads in both packages
    jx = flatnav_tpu.index.load_index(index_path)
    px = flatnav_tpu_torch.index.load_index(index_path, device="cpu")
    assert jx.num_nodes == px.num_nodes == 1200 and jx.max_edges_per_node == 8
    np.testing.assert_array_equal(np.asarray(jx.graph.links[:1200]),
                                  px.graph.links[:1200].numpy())

    for extra in ([], ["--reorder"]):
        r = _run(["-m", "flatnav_tpu_torch.tools.query", index_path, paths["queries"],
                  paths["gtruth"], "--ef-search", "48", "96", "--k", "10", "--batch", "64",
                  "--device", "cpu", *extra])
        assert r.returncode == 0, r.stderr[-2000:]
        recalls = [float(line.split("recall@10=")[1].split()[0])
                   for line in r.stdout.splitlines() if "recall@10=" in line]
        assert len(recalls) == 2 and min(recalls) > 0.8
        assert ("gorder reordering" in r.stdout) == bool(extra)

    # without --device cpu and without a card the CLIs exit nonzero
    r = _run(["-m", "flatnav_tpu_torch.tools.query", index_path, paths["queries"],
              paths["gtruth"]])
    assert r.returncode != 0 and "device='cpu'" in r.stderr


def test_cli_quantized_and_limit(npy_triplet):
    paths, td = npy_triplet
    out = str(td / "cli_pq.idx")
    r = _run(["-m", "flatnav_tpu_torch.tools.construct", "1", paths["train"], "8", "32", out,
              "--quantized", "--pq-m", "4", "--limit", "600", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loaded 600 x 16" in r.stdout and "saved PQ index" in r.stdout
    from flatnav_tpu_torch.quantization import PQIndex

    assert PQIndex.load(out, device="cpu").num_nodes == 600


def test_port_query_reads_an_index_written_by_the_jax_construct(npy_triplet):
    paths, td = npy_triplet
    index_path = str(td / "jax_cli_index.npz")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv = %r;"
        "g = {'__file__': 'tools/construct.py', '__name__': '__main__'};"
        "exec(open(g['__file__']).read(), g)"
    ) % (["construct.py", "0", paths["train"], "8", "32", index_path],)
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run(["-m", "flatnav_tpu_torch.tools.query", index_path, paths["queries"],
              paths["gtruth"], "--ef-search", "64", "--k", "10", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    recall = float(r.stdout.split("recall@10=")[1].split()[0])
    assert recall > 0.8
