"""A run, driven on the CPU at a toy size past the harness's look for a card:
sound runs come out correct with their metrics; runs with the timed path
broken underneath, and the control, come out not correct. Also: the command
fails without a card, and nothing of JAX or the JAX package is loaded."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from annbench import check, control, faults, synth
from annbench.run import run_cell
from conftest import REPO

SEED = 2**31 + 4242


def _run(reg, cell, trace=False, seed=SEED):
    return run_cell(reg, cell, seed, 0.4, trace, device="cpu")


@pytest.mark.parametrize("cell", ["toy.graph", "toy.scan"])
def test_sound_run_is_correct_with_its_metrics(toy_reg, cell):
    r = _run(toy_reg, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    # every end-to-end metric of the cell but peak_gib: no card, no device
    # memory reading (the toy graph cell, like sift1m.graph, has its p95 per
    # layer, request.p95_ms)
    want = {m["name"] for m in toy_reg.metrics(cell, "end_to_end")} - {"peak_gib"}
    assert {"qps", "recall_at_10", "setup_s"} <= want and set(r["metrics"]) == want
    assert list(r)[-1] == "check" and r["check"]["dist_gap"]["value"] < 1e-5


@pytest.mark.parametrize("cell,want", [
    ("toy.graph", {"build_s", "search.hops_per_query", "search.ms_per_hop",
                   "search.host_ms_per_hop", "search.dist_comps_per_query", "request.p95_ms"}),
    ("toy.scan", set()),
])
def test_traced_run_gives_its_layer_metrics(toy_reg, cell, want):
    r = _run(toy_reg, cell, trace=True)
    assert r["correct"] and set(r["metrics"]) == want
    assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _k2_off(monkeypatch):
    import flatnav_tpu_torch.index.search as s

    real = s.gather_distances
    monkeypatch.setattr(s, "gather_distances", lambda v, i, q, m: real(v, i, q, m) * 1.001)


def _answer_altered(monkeypatch):
    import flatnav_tpu_torch.index.api as api

    real = api.Index.search

    def search(self, *a, **kw):
        d, ids = real(self, *a, **kw)
        ids = ids.copy()
        ids[0, 0] = ids[0, -1]
        return d, ids
    monkeypatch.setattr(api.Index, "search", search)


def _half_left_out(monkeypatch):
    import flatnav_tpu_torch.index.api as api

    real = api.Index.search

    def search(self, queries, *a, **kw):
        d, ids = real(self, queries[: len(queries) // 2], *a, **kw)
        return d, ids
    monkeypatch.setattr(api.Index, "search", search)


def _labels_shifted(monkeypatch):
    import flatnav_tpu_torch.index.api as api

    real = api.Index.search_exact

    def search_exact(self, *a, **kw):
        d, ids = real(self, *a, **kw)
        return d, (ids + 1) % self.num_nodes
    monkeypatch.setattr(api.Index, "search_exact", search_exact)


def _rerank_skipped(monkeypatch):
    import flatnav_tpu_torch.index.api as api

    real = api.Index.search_exact
    monkeypatch.setattr(api.Index, "search_exact",
                        lambda self, q, K, rerank: real(self, q, K, rerank, exact_rerank=False))


def _no_back_edges(monkeypatch):
    faults.no_back_edges(monkeypatch.setattr)


def _tile_dropped(monkeypatch):
    faults.tile_dropped(monkeypatch.setattr, tile=64)


@pytest.mark.parametrize("cell,fault,fails", [
    ("toy.graph", _k2_off, "dist_gap"),
    ("toy.graph", _answer_altered, "bad_rows"),
    ("toy.graph", _half_left_out, "missing"),
    ("toy.graph", _no_back_edges, "recall_at_10"),
    ("toy.scan", _labels_shifted, "dist_gap"),
    ("toy.scan", _rerank_skipped, "dist_gap"),
    ("toy.scan", _tile_dropped, "recall_at_10"),
])
def test_broken_timed_path_is_not_correct(toy_reg, monkeypatch, cell, fault, fails):
    fault(monkeypatch)
    r = _run(toy_reg, cell)
    v = r["check"][fails]
    assert not r["correct"]
    assert v["value"] < v["limit"] if fails == "recall_at_10" else v["value"] > v["limit"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(toy_reg, seed):
    """The reference in TF32 in the program's place fails `dist_gap`; the
    reference itself passes every number."""
    cfg = toy_reg.config("toy")
    limits = toy_reg.traffic("toy-scan-r1000")["limits"]
    data, q = synth.generate(cfg, seed, "cpu")
    ok, numbers, _ = check.judge(data, q, control.control_answers(data, q, 10, "l2", 100),
                                 10, "l2", limits)
    assert not ok and numbers["dist_gap"][0] > 3 * limits["dist_gap"]
    from annbench import reference

    d, i = reference.exact_knn(data, q, 10)
    ok, numbers, recall = check.judge(data, q, [(0, d.numpy(), i.numpy())], 10, "l2", limits)
    assert ok and recall == 1.0


def test_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "annbench/run.py", "--workload", "sift1m.scan",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_jax_is_loaded():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import annbench.reference, annbench.check, annbench.synth, annbench.bounds\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'flatnav_tpu', 'flatnav_tpu_torch'}, tops\n"
        "import annbench.run, annbench.spans, annbench.trace, annbench.control, annbench.faults\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'flatnav_tpu'}, tops\n"
        "assert annbench.run.forbidden_modules() == []\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr


@pytest.mark.gpu
def test_control_on_the_card():
    """The control at SIFT's width on the card, 200,000 rows: TF32 products
    fail `dist_gap`, the float32 reference passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from annbench import reference

    data, q = synth.clustered(200_000, 128, 1000, 11, "cuda")
    limits = {"dist_gap": 1e-5, "recall_floor": 0.9985}
    ok, numbers, _ = check.judge(data, q, control.control_answers(data, q, 10, "l2", 1000),
                                 10, "l2", limits)
    assert not ok and numbers["dist_gap"][0] > 3e-5
    d, i = reference.exact_knn(data, q, 10)
    ok, _, _ = check.judge(data, q, [(0, d.cpu().numpy(), i.cpu().numpy())], 10, "l2", limits)
    assert ok
