"""The port's BigANN-class runners (flatnav_tpu_torch.bench.bigann_10m and
bigann_100m) on the CPU at a few thousand rows, held against the JAX package
on the same numpy inputs: the 100M generator byte-equal to the JAX runner's
(imported by path, its scratch in a temporary directory), the results dicts
with the JAX results files' keys, and each engine's recall within 0.01 of
JAX's own functions on the same uint8 arrays, exact ids equal."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from flatnav_tpu.bench.synth import clustered as jax_clustered
from flatnav_tpu.index import batched_search as jax_batched_search
from flatnav_tpu.index.build import add_batch as jax_add_batch
from flatnav_tpu.index.graph import make_empty_graph as jax_empty
from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import brute_force_knn as jax_brute
from flatnav_tpu.ops import fast_knn as jax_fast
from flatnav_tpu.ops import fused_knn as jax_fused
from flatnav_tpu_torch.bench import _northstar as ns
from flatnav_tpu_torch.bench import bigann_10m, bigann_100m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NQ, EF, E = 1500, 64, 64, 16


def _jax_keys(name):
    with open(os.path.join(REPO, "benchmarks", name)) as f:
        return set(json.load(f))


@pytest.fixture(scope="module")
def run_10m(tmp_path_factory):
    """The 10M runner at N uint8 rows (the calibrated 397-centre generator)
    on the CPU, PQ and PQ graph included, in a temporary directory."""
    tmp = tmp_path_factory.mktemp("bigann10m")
    mp = pytest.MonkeyPatch()
    mp.setenv("FLATNAV_SCRATCH", str(tmp / "scratch"))
    mp.setattr(bigann_10m, "BATCH", NQ // 2)
    mp.setattr(bigann_10m, "EF_GRID", (EF,))
    mp.setattr(bigann_10m, "E_GRID", (E,))
    mp.setattr(bigann_10m, "PQ_RERANKS", (128,))
    mp.setattr(bigann_10m, "PQ_GRAPH_POINTS", ((EF, E),))
    try:
        res = bigann_10m.main(["--n", str(N), "--nq", str(NQ), "--efc", "32", "--n-centers", "397",
                               "--m-pq", "8", "--m-pq4", "8", "--pq-graph", "--device", "cpu",
                               "--results-dir", str(tmp / "results")])
    finally:
        mp.undo()
    return res, tmp


@pytest.fixture(scope="module")
def jax_10m():
    data, queries = jax_clustered(N, 128, NQ, dtype=np.uint8, n_centers=397)
    q = jnp.asarray(queries)
    l2 = JMetric.L2
    _, gt = jax_brute(jnp.asarray(data), q, 10, l2)
    gt = np.asarray(gt)
    g = jax_add_batch(jax_empty(N, 128, 32, dtype=jnp.uint8), data, np.arange(N),
                      ef_construction=32, metric=l2)
    found = {
        "fast": jax_fast(g.vectors, q, 10, l2, tile_size=262144, rerank=32, n_valid=g.num_nodes)[1],
        "fused": jax_fused(g.vectors, q, 10, l2, rerank=32, n_valid=g.num_nodes)[1],
        "fusednr": jax_fused(g.vectors, q, 10, l2, rerank=32, n_valid=g.num_nodes,
                             exact_rerank=False)[1],
        "graph": jax_batched_search(g.vectors, g.links, g.labels, g.num_nodes, q, k=10, ef=EF,
                                    metric=l2, expand_factor=E).labels,
    }
    return {name: ns.recall(np.asarray(ids), gt) for name, ids in found.items()}, gt


def test_10m_results_have_the_jax_files_keys(run_10m):
    res, tmp = run_10m
    # the JAX runner writes reference_single_core only where a sidecar exists
    jax_keys = _jax_keys("results_bigann-c26_10m.json") - {"reference_single_core"}
    assert set(res) == jax_keys | {"pq_graph_engine", "device", "reduced", "build_peak_bytes",
                                   "scan_peak_bytes", "kernel_build_seconds", "build_launches",
                                   "launches", "kernels"}
    assert res["device"] == "cpu" and res["generator"] == {"n_centers": 397}
    assert res["reduced"] == [f"n={N} of the source's 10000000 rows",
                              f"{NQ} queries of the source's 8192"]
    assert res["workload"] == f"clustered uint8 {N}x128 L2 M=32 efc=32 k=10"
    with open(tmp / "results" / f"results_bigann-nc397_10m_n{N}.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))


def test_10m_engines_match_jax(run_10m, jax_10m):
    res, tmp = run_10m
    jax_recall, jax_gt = jax_10m
    gt = np.load(tmp / "scratch" / f"10m_gt_bigann-nc397_{N}_128.npy")
    assert np.array_equal(gt, jax_gt)  # exact integer distances: the same ids
    assert res["exact_engine"]["recall"] == 1.0
    for name in ("fast", "fused", "fusednr"):
        assert abs(res[f"{name}_engine"]["recall"] - jax_recall[name]) <= 0.01, name
    row = next(r for r in res["sweep"] if r["ef"] == EF and r["expand"] == E)
    assert abs(row["recall"] - jax_recall["graph"]) <= 0.01
    assert "qps" in res["graph_operating_point"]


def test_10m_pq_points(run_10m):
    res, _ = run_10m
    p8, p4, pg = res["pq_scan_engine"], res["pq4_scan_engine"], res["pq_graph_engine"]
    assert p8["code_bytes_per_node"] == 8 and p4["code_bytes_per_node"] == 4 and p4["nbits"] == 4
    assert p8["rerank"] in (64, 128) and p4["rerank"] in (64, 128)
    # the raw rerank can only recover what the codebook's shortlist holds
    assert 0 <= p8["adc_only_recall"] <= p8["recall"] <= 1
    assert pg["ef"] == EF and pg["rerank"] == min(EF, 128) and 0 < pg["recall"] <= 1


def _import_jax_100m(monkeypatch, scratch):
    """benchmarks/run_bigann_100m.py by path, with its scratch under
    `scratch` (read at import) and the suite's compile cache."""
    monkeypatch.setenv("FLATNAV_SCRATCH", str(scratch))
    monkeypatch.setenv("FLATNAV_TPU_CACHE", os.path.join(REPO, ".test_compile_cache"))
    spec = importlib.util.spec_from_file_location(
        "jax_run_bigann_100m", os.path.join(REPO, "benchmarks", "run_bigann_100m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workers", [1, 2])
def test_100m_generator_is_byte_equal_to_the_jax_runners(tmp_path, monkeypatch, workers):
    jax_mod = _import_jax_100m(monkeypatch, tmp_path / "jax")
    want_d, want_q = jax_mod.gen_dataset(n=20000)
    monkeypatch.setenv("FLATNAV_SCRATCH", str(tmp_path / "port"))
    data, queries = bigann_100m.gen_dataset(n=20000, workers=workers)
    assert data.dtype == np.uint8 and data.shape == (20000, 128) and not data.flags.writeable
    assert np.array_equal(np.asarray(data), np.asarray(want_d))
    assert np.array_equal(queries, want_q)
    # and a second call reads the files back
    again, q2 = bigann_100m.gen_dataset(n=20000, nq=100)
    assert np.array_equal(np.asarray(again), np.asarray(want_d)) and np.array_equal(q2, want_q[:100])


def test_100m_runner_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("FLATNAV_SCRATCH", str(tmp_path / "scratch"))
    monkeypatch.setattr(bigann_100m, "PQ_RERANKS", ())
    monkeypatch.setattr(bigann_100m, "PQ4_RERANKS", (128,))
    res = bigann_100m.main(["--n", "20000", "--nq", str(NQ), "--b", "32", "--pq-b", "32",
                            "--m-pq", "8", "--m-pq4", "8", "--workers", "1", "--device", "cpu",
                            "--results-dir", str(tmp_path / "results")])
    jax_keys = {"workload", "note", "batch", "fused_autoshaped", "device", "fused_engine",
                "fusednr_engine", "exact_engine", "pq_scan_engine", "pq4_scan_engine"}
    assert jax_keys <= _jax_keys("results_bigann_100m_class.json") | {"pq_scan_engine"}
    assert set(res) == jax_keys | {"reduced", "fused_shapes", "scan_peak_bytes",
                                   "kernel_build_seconds", "launches", "kernels"}
    assert res["exact_engine"]["recall"] == 1.0
    # the port's phase B and shortlists are exact: the scans meet the JAX bar
    assert res["fused_engine"]["recall"] >= 0.9942 and res["fusednr_engine"]["recall"] >= 0.9942
    assert res["fused_shapes"]["query_chunk"] >= 32 and res["kernels"] == {"scan_buckets": None}
    assert res["pq_scan_engine"]["rerank"] == 64 and res["pq4_scan_engine"]["nbits"] == 4
    assert res["reduced"][0] == "n=20000 of the source's 100000000 rows"
    assert os.path.exists(tmp_path / "results" / "results_bigann_100m_class_n20000.json")


def test_100m_engines_match_jax_on_the_same_table(tmp_path, monkeypatch):
    # the generated table through JAX's exact and fused scans and the port's
    import torch

    from flatnav_tpu_torch.ops import brute_force_knn, fused_knn

    monkeypatch.setenv("FLATNAV_SCRATCH", str(tmp_path))
    data, queries = bigann_100m.gen_dataset(n=20000, nq=NQ)
    table, q = np.array(data), queries  # a writable copy of the memmap
    _, jax_gt = jax_brute(jnp.asarray(table), jnp.asarray(q), 10, JMetric.L2)
    _, jax_f = jax_fused(jnp.asarray(table), jnp.asarray(q), 10, JMetric.L2, rerank=32)
    _, gt = brute_force_knn(torch.from_numpy(table), torch.from_numpy(q), 10)
    _, fi = fused_knn(torch.from_numpy(table), torch.from_numpy(q), 10, rerank=32)
    assert np.array_equal(gt.numpy(), np.asarray(jax_gt))
    assert abs(ns.recall(fi.numpy(), gt.numpy()) - ns.recall(np.asarray(jax_f), gt.numpy())) <= 0.01
