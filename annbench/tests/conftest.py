"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark with
toy configurations (one in each data form the harness takes) and two toy
mixes added as new files and entries, the way a later change adds a cell."""

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


#: toy configurations in the data forms other than SIFT's, by name: the
#: changes laid over SIFT's file
FORM_TOYS = {
    "toy-angular": {"metric": "angular"},
    "toy-uint8": {"dtype": "uint8"},
    "toy-int8": {"dtype": "int8"},
}


def add_toy(root: Path, name: str = "toy", **changes) -> None:
    """Adds configuration `name` (SIFT's file at the TOY sizes, with
    `changes` laid over it) and cells `<name>.graph` / `<name>.scan` to the
    benchmark copied at `root`: new files and new entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "annbench/configs/sift-128-euclidean.json").read_text())
    cfg.update(name=name, **TOY, **changes)
    cfg["graph"] = {"args": {"ef_search": 96}, "setters": {"set_expand_factor": 8},
                    "limits": {"recall_floor": 0.9}}
    (root / f"annbench/configs/{name}.json").write_text(json.dumps(cfg))
    for mix in ("graph-r1000", "scan-r1000"):
        t = json.loads((root / f"annbench/traffic/{mix}.json").read_text())
        t.update(name=f"toy-{mix}", request_queries=100, trace_requests=3, warmup_passes=1)
        (root / f"annbench/traffic/toy-{mix}.json").write_text(json.dumps(t))
    bench["configs"].append({"name": name, "source": "toy", "why": "toy",
                             "file": f"annbench/configs/{name}.json", "reduced": []})
    bench["workloads"] += [
        {"name": f"{name}.{c}", "config": name, "traffic": f"toy-{c}-r1000", "chips": 1,
         "why": "toy"} for c in ("graph", "scan")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("sift1m", name) for w in m["workloads"]
                               if w.startswith("sift1m")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "annbench", root / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    add_toy(root)
    for name, changes in FORM_TOYS.items():
        add_toy(root, name, **changes)
    return root


@pytest.fixture(scope="session")
def toy_reg(toy_root):
    from annbench.registry import Registry

    return Registry(toy_root)
