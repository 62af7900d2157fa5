"""The port's north-star runner (flatnav_tpu_torch.bench.northstar) on the
CPU at a few thousand rows, held against the JAX package on the same numpy
inputs: the generator bit-equal at each configuration's settings, the
runner's results dict with the JAX results file's keys, and each engine's
recall within 0.01 of JAX's own functions (`add_batch`, `batched_search`,
`brute_force_knn`, `fast_knn`, `fused_knn` in interpret mode) on the same
arrays, exact ids equal. The JAX runner script itself is not run: it writes
into benchmarks/."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.bench.synth import clustered as jax_clustered
from flatnav_tpu.index import batched_search as jax_batched_search
from flatnav_tpu.index.build import add_batch as jax_add_batch
from flatnav_tpu.index.graph import graph_from_numpy as jax_from_numpy
from flatnav_tpu.index.graph import make_empty_graph as jax_empty
from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import brute_force_knn as jax_brute
from flatnav_tpu.ops import fast_knn as jax_fast
from flatnav_tpu.ops import fused_knn as jax_fused
from flatnav_tpu_torch.bench import _northstar as ns
from flatnav_tpu_torch.bench import northstar
from flatnav_tpu_torch.bench.synth import clustered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NQ, EFC, EF, E = 2000, 64, 32, 32, 16


def _jax_runner_data(config, n, nq, **gen_kw):
    """The JAX runner's arrays (benchmarks/run_northstar.py:142-146)."""
    dim = {"clustered": 128, "angular": 100, "gist": 960}[config]
    data, queries = jax_clustered(n, dim, nq, **gen_kw)
    if config == "angular":
        data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-12
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-12
    return data, queries


@pytest.mark.parametrize("config,n", [("clustered", 5000), ("angular", 5000), ("gist", 1500)])
def test_runner_data_is_the_jax_runners(monkeypatch, config, n):
    # each configuration at the c26 setting the JAX results files record
    monkeypatch.setattr(northstar, "NQ", 100)
    data, queries = northstar.make_data(config, n, {"centers_per_64k": 26})
    want_d, want_q = _jax_runner_data(config, n, 100, centers_per_64k=26)
    assert data.dtype == want_d.dtype == np.float32
    assert np.array_equal(data, want_d) and np.array_equal(queries, want_q)


@pytest.mark.parametrize("kw", [{}, {"centers_per_64k": 26}, {"n_centers": 397, "dtype": np.uint8}])
def test_generator_is_bit_equal(kw):
    got = clustered(3000, 128, 50, **kw)
    want = jax_clustered(3000, 128, 50, **kw)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))


@pytest.fixture(scope="module")
def angular_run(tmp_path_factory):
    """The runner at N angular rows on the CPU, with its scratch (build
    checkpoint, ground truth) and results in a temporary directory."""
    tmp = tmp_path_factory.mktemp("northstar")
    mp = pytest.MonkeyPatch()
    mp.setenv("FLATNAV_SCRATCH", str(tmp / "scratch"))
    mp.setattr(northstar, "NQ", NQ)
    mp.setattr(northstar, "BATCH", NQ // 2)
    mp.setattr(northstar, "EF_SWEEP", (16, EF))
    mp.setattr(northstar, "E_SWEEP", (E,))
    try:
        res = northstar.main(["--config", "angular", "--n", str(N), "--efc", str(EFC),
                              "--centers-per-64k", "26", "--target", "0.995", "--device", "cpu",
                              "--results-dir", str(tmp / "results")])
    finally:
        mp.undo()
    return res, tmp


@pytest.fixture(scope="module")
def jax_angular():
    """JAX's own engines on the same arrays: recall of each against JAX's
    exact ids, and those ids."""
    data, queries = _jax_runner_data("angular", N, NQ, centers_per_64k=26)
    q = jnp.asarray(queries)
    ip = JMetric.IP
    _, gt = jax_brute(jnp.asarray(data), q, 10, ip)
    gt = np.asarray(gt)
    g = jax_add_batch(jax_empty(N, 100, 32), data, np.arange(N), ef_construction=EFC, metric=ip)
    found = {
        "fast": jax_fast(g.vectors, q, 10, ip, tile_size=262144, rerank=32, n_valid=g.num_nodes)[1],
        "fused": jax_fused(g.vectors, q, 10, ip, rerank=32, n_valid=g.num_nodes)[1],
        "fusednr": jax_fused(g.vectors, q, 10, ip, rerank=32, n_valid=g.num_nodes,
                             exact_rerank=False)[1],
        "graph": jax_batched_search(g.vectors, g.links, g.labels, g.num_nodes, q, k=10, ef=EF,
                                    metric=ip, expand_factor=E).labels,
    }
    return {name: ns.recall(np.asarray(ids), gt) for name, ids in found.items()}, gt


def test_results_have_the_jax_files_keys(angular_run):
    res, tmp = angular_run
    with open(os.path.join(REPO, "benchmarks", "results_gist-c26_efc100.json")) as f:
        jax_keys = set(json.load(f))
    assert set(res) == jax_keys | {"device", "reduced", "build_peak_bytes", "kernel_build_seconds",
                                   "build_launches", "launches", "kernels"}
    assert res["device"] == "cpu" and res["kernels"] is None and res["kernel_build_seconds"] is None
    assert res["reduced"] == [f"n={N} of the source's 1000000 rows",
                              f"{NQ} queries of the source's 8192"]
    assert res["workload"] == f"angular-c26 {N}x100 fp32 ip M=32 efc={EFC} k=10"
    assert res["generator"] == {"centers_per_64k": 26} and res["build_dtype"] == "float32"
    assert res["reference_single_core"] is None  # read from a sidecar at 1M rows only
    with open(tmp / "results" / f"results_angular-c26_efc{EFC}_n{N}.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))


def test_engines_match_jax(angular_run, jax_angular):
    res, tmp = angular_run
    jax_recall, jax_gt = jax_angular
    gt = np.load(tmp / "scratch" / f"ns_angular-c26_{N}_gt.npy")
    assert np.array_equal(gt, jax_gt)  # the exact engine's ids
    assert res["exact_engine"]["recall"] == 1.0
    for name in ("fast", "fused", "fusednr"):
        point = res[f"{name}_engine"]
        assert abs(point["recall"] - jax_recall[name]) <= 0.01, name
        assert point["qps"] > 0 and point["mfu"] <= 1
        assert point["launches"]["scan_buckets"] == 0  # the plain versions ran
    row = next(r for r in res["sweep"] if r["ef"] == EF and r["expand"] == E)
    assert abs(row["recall"] - jax_recall["graph"]) <= 0.01


def test_sweep_stops_at_the_target_and_times_the_point(angular_run):
    res, _ = angular_run
    rows = res["sweep"]
    met = [r for r in rows if r["recall"] >= 0.995]
    assert all("qps" in r for r in met) and all("qps" not in r for r in rows if r not in met)
    assert len(met) <= 1 and rows[-1] in met or not met
    if met:
        assert res["graph_operating_point"] == dict(met[0], efc=EFC)


def test_checkpoint_resumes_without_rebuilding(angular_run, monkeypatch, capsys):
    # a second run finds the build checkpoint and the cached ground truth
    res, tmp = angular_run
    monkeypatch.setenv("FLATNAV_SCRATCH", str(tmp / "scratch"))
    monkeypatch.setattr(northstar, "NQ", NQ)
    monkeypatch.setattr(northstar, "EF_SWEEP", (EF,))
    monkeypatch.setattr(northstar, "E_SWEEP", (E,))
    again = northstar.main(["--config", "angular", "--n", str(N), "--efc", str(EFC),
                            "--centers-per-64k", "26", "--skip-scan-engines", "--device", "cpu",
                            "--results-dir", str(tmp / "again")])
    assert again["build_seconds"] == res["build_seconds"]
    assert again["fast_engine"] is None and "scan engines skipped" in again["reduced"][-1]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(again))


def test_bf16_build_serves_the_float32_rows(tmp_path, monkeypatch):
    # --build-dtype bfloat16, as the JAX gist run was built: links from the
    # bf16 table, searched over the float32 rows, against JAX's runner steps
    monkeypatch.setenv("FLATNAV_SCRATCH", str(tmp_path / "scratch"))
    monkeypatch.setattr(northstar, "NQ", NQ)
    monkeypatch.setattr(northstar, "BATCH", NQ)
    monkeypatch.setattr(northstar, "EF_SWEEP", (EF,))
    monkeypatch.setattr(northstar, "E_SWEEP", (E,))
    res = northstar.main(["--config", "angular", "--n", str(N), "--efc", str(EFC),
                          "--centers-per-64k", "26", "--build-dtype", "bfloat16",
                          "--skip-scan-engines", "--device", "cpu",
                          "--results-dir", str(tmp_path / "results")])
    assert res["build_dtype"] == "bfloat16"
    assert os.path.exists(tmp_path / "scratch" / f"ns_angular-c26_{N}_100_32_{EFC}_bf16.npz")
    data, queries = _jax_runner_data("angular", N, NQ, centers_per_64k=26)
    ip = JMetric.IP
    g = jax_add_batch(jax_empty(N, 100, 32, dtype=jnp.bfloat16), data, np.arange(N),
                      ef_construction=EFC, metric=ip)
    g = jax_from_numpy(data, np.asarray(g.links[:N]), num_nodes=N, capacity=N)
    assert g.vectors.dtype == jnp.float32
    q = jnp.asarray(queries)
    gt = np.asarray(jax_brute(jnp.asarray(data), q, 10, ip)[1])
    found = jax_batched_search(g.vectors, g.links, g.labels, g.num_nodes, q, k=10, ef=EF,
                               metric=ip, expand_factor=E).labels
    assert abs(res["sweep"][0]["recall"] - ns.recall(np.asarray(found), gt)) <= 0.01


def test_baseline_is_the_jax_sidecar_at_full_scale_only():
    with open(os.path.join(REPO, "benchmarks",
                           "results_angular-c26_efc200.json.refside.json")) as f:
        assert ns.sidecar("angular-c26", 200) == json.load(f)
    assert ns.sidecar("angular-c26", 7) is None


def test_runner_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        northstar.main(["--config", "clustered", "--n", "100"])


def test_recorded_hop_keeps_a_full_width_hop_and_puts_k2_back():
    from flatnav_tpu_torch.index import search as search_mod
    from flatnav_tpu_torch.index.build import add_batch
    from flatnav_tpu_torch.index.graph import make_empty_graph
    from flatnav_tpu_torch.index.search import batched_search
    from flatnav_tpu_torch.ops import MetricType

    data, queries = clustered(600, 16, 32, seed=3)
    g = make_empty_graph(600, 16, 8, device="cpu")
    add_batch(g, data, np.arange(600), ef_construction=32, metric=MetricType.L2)
    k2 = search_mod.gather_distances
    q = torch.from_numpy(queries)
    with ns.recorded_hop(2 * 8, nth=2) as hop:
        want = batched_search(g.vectors, g.links, g.labels, g.num_nodes, q, k=10, ef=32,
                              expand_factor=2).labels
    assert search_mod.gather_distances is k2
    vectors, ids, got_q, _ = hop.args
    assert hop.seen >= 2 and ids.shape == (32, 16)
    assert vectors is g.vectors and torch.equal(got_q, q)  # the table by reference only
    # the recorder only watches: the search returns what it does without it
    again = batched_search(g.vectors, g.links, g.labels, g.num_nodes, q, k=10, ef=32,
                           expand_factor=2).labels
    assert torch.equal(torch.as_tensor(want), torch.as_tensor(again))
