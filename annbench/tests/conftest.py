"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark with a
toy configuration and two toy mixes added as new files and entries, the way
a later change adds a cell."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TOY = {"n": 3000, "dim": 16, "num_queries": 300, "max_edges_per_node": 16,
       "ef_construction": 64}


def add_toy(root: Path) -> None:
    """Adds configuration `toy` and cells `toy.graph` / `toy.scan` to the
    benchmark copied at `root`: new files and new entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "annbench/configs/sift-128-euclidean.json").read_text())
    cfg.update(name="toy", **TOY)
    cfg["graph"] = {"args": {"ef_search": 96}, "setters": {"set_expand_factor": 8},
                    "limits": {"recall_floor": 0.9}}
    (root / "annbench/configs/toy.json").write_text(json.dumps(cfg))
    for mix in ("graph-r1000", "scan-r1000"):
        t = json.loads((root / f"annbench/traffic/{mix}.json").read_text())
        t.update(name=f"toy-{mix}", request_queries=100, trace_requests=3, warmup_passes=1)
        (root / f"annbench/traffic/toy-{mix}.json").write_text(json.dumps(t))
    bench["configs"].append({"name": "toy", "source": "toy", "why": "toy",
                             "file": "annbench/configs/toy.json", "reduced": []})
    bench["workloads"] += [
        {"name": "toy.graph", "config": "toy", "traffic": "toy-graph-r1000", "chips": 1, "why": "toy"},
        {"name": "toy.scan", "config": "toy", "traffic": "toy-scan-r1000", "chips": 1, "why": "toy"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("sift1m", "toy") for w in m["workloads"]
                               if w.startswith("sift1m")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "annbench", root / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    add_toy(root)
    return root


@pytest.fixture(scope="session")
def toy_reg(toy_root):
    from annbench.registry import Registry

    return Registry(toy_root)
