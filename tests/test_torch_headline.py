"""The port's headline benchmark (flatnav_tpu_torch.bench.headline) on the
CPU at a small size: the last line it prints, `--time-only` over the index it
saved, and its refusal to run without a card unless asked for the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flatnav_tpu_torch.bench import headline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--n", "3000", "--dim", "32", "--num-queries", "256", "--batch", "256", "--m", "16"]
KEYS = {
    "metric", "value", "unit", "engine", "recall", "recall_dist_based", "vs_baseline",
    "exact_qps", "exact_recall", "fast_qps", "fast_recall", "fused_qps", "fused_recall",
    "fusednr_qps", "fusednr_recall", "graph_qps", "graph_recall", "ef_search",
    "expand_factor", "compact_width", "m_search", "num_init", "build_seconds",
    "achieved_tflops", "mfu", "engine_mfu", "peak_tflops", "device", "baseline_qps",
    "baseline_recall", "baseline_ef_search", "workload_key", "kernel_launches",
}


def _run(*argv):
    return subprocess.run(
        [sys.executable, "-m", "flatnav_tpu_torch.bench.headline", *argv],
        capture_output=True, text=True, timeout=600, cwd=REPO)


def test_headline_last_line_and_time_only(tmp_path):
    files = ["--index", str(tmp_path / "ix.npz"), "--queries-file", str(tmp_path / "q.npy")]
    r = _run("--device", "cpu", *SIZE, *files)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(out) == KEYS and "engine_faults" not in out
    assert out["unit"] == "qps" and out["metric"] == "qps@recall0.95_clustered3k_d32_k10"
    assert out["exact_recall"] == 1.0 and out["exact_qps"] > 0
    assert out["engine"] in ("graph", "exact", "fast", "fused", "fusednr")
    assert out["value"] == out[out["engine"] + "_qps"] > 0
    assert out["recall"] >= 0.95
    assert out["graph_recall"] >= 0.95 and out["ef_search"] in headline.EF_SWEEP
    assert out["expand_factor"] in headline.E_SWEEP
    assert out["fused_recall"] >= 0.95 and out["fast_recall"] >= 0.95
    # the workload is not the recorded baseline's: nothing is invented
    assert out["vs_baseline"] is None and out["baseline_qps"] is None
    assert out["peak_tflops"] == 989.0 and out["device"] == "cpu"
    assert set(out["engine_mfu"]) == {"exact", "fast", "fused", "fusednr"}
    if out["engine"] != "graph":
        assert 0 <= out["mfu"] <= 1  # rounded to four places: a CPU rate reads 0.0
    # the plain versions ran: no kernel is launched on the CPU
    assert out["kernel_launches"] == {"scan_buckets": 0, "gather_distances": 0}

    for engine_args in (["--engine", "fused"],
                        ["--engine", "graph", "--ef-search", "64", "--expand-factor", "16",
                         "--m-search", "8", "--compact-width", "64"]):
        r = _run("--device", "cpu", "--time-only", "--repeats", "1", "--batch", "256",
                 *files, *engine_args)
        assert r.returncode == 0, r.stderr[-2000:]
        timed = json.loads(r.stdout.strip().splitlines()[-1])
        assert set(timed) == {"qps"} and timed["qps"] > 0


def test_headline_needs_a_card_by_default():
    r = _run(*SIZE)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "pass device='cpu' to run on the CPU" in r.stderr


def test_an_engine_that_raises_ends_the_run(monkeypatch, tmp_path, capsys):
    def broken(*a, **kw):
        raise ValueError("engine fault")

    monkeypatch.setitem(headline.SCAN_ENGINES, "fast", broken)
    with pytest.raises(ValueError, match="engine fault"):
        headline.main(["--device", "cpu", "--n", "600", "--dim", "16", "--num-queries", "32",
                       "--batch", "32", "--m", "8", "--index", str(tmp_path / "ix.npz"),
                       "--queries-file", str(tmp_path / "q.npy")])
    assert capsys.readouterr().out.strip() == ""  # no result line


def test_baseline_is_read_only_for_the_matching_workload():
    with open(os.path.join(REPO, "baseline_ref.json")) as f:
        ref = json.load(f)
    assert headline._reference_baseline(ref["workload_key"]) == ref
    assert headline._reference_baseline("0" * 16) == {}
    # the key is the root bench.py's rule: the first 64 rows and the shape
    args = headline.parse_args([])
    data, _ = headline._make_data(headline.parse_args(["--n", "5000", "--num-queries", "8"]))
    assert len(headline._workload_key(args, data)) == 16
    assert headline._workload_key(args, data) != headline._workload_key(args, data + 1)


@pytest.mark.parametrize("data,dtype", [("random", "uint8"), ("clustered", "bfloat16")])
def test_headline_other_tables(data, dtype, tmp_path, capsys):
    headline.main(["--device", "cpu", "--n", "1500", "--dim", "16", "--num-queries", "64",
                   "--batch", "64", "--m", "8", "--data", data, "--dtype", dtype,
                   "--repeats", "1", "--index", str(tmp_path / "ix.npz"),
                   "--queries-file", str(tmp_path / "q.npy")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"].endswith(f"_{dtype}")
    # a bfloat16 table is not the float32 data the ground truth was taken on
    assert out["exact_recall"] == 1.0 if dtype == "uint8" else 0.99 <= out["exact_recall"] <= 1.0
    assert out["vs_baseline"] is None and out["value"] > 0
    assert np.load(tmp_path / "q.npy").shape == (64, 16)
    assert torch.cuda.is_available() or out["device"] == "cpu"


def test_headline_counts_only_its_own_launches(tmp_path, capsys, monkeypatch):
    """A caller in the same process may have launched kernels before `main`:
    the line counts from `main`'s start, not from the process's."""
    from flatnav_tpu_torch.ops.fused_scan import scan_buckets
    from flatnav_tpu_torch.ops.gather_distance import gather_distances

    monkeypatch.setattr(scan_buckets, "launches", 7)
    monkeypatch.setattr(gather_distances, "launches", 11)
    headline.main(["--device", "cpu", "--n", "1000", "--dim", "16", "--num-queries", "64",
                   "--batch", "64", "--m", "8", "--index", str(tmp_path / "ix.npz"),
                   "--queries-file", str(tmp_path / "q.npy")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["kernel_launches"] == {"scan_buckets": 0, "gather_distances": 0}
