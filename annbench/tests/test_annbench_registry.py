"""The benchmark's files: every one loads and is found by name, BENCHMARK.json
keeps to its contract, and a configuration and a mix added as new files and
entries are found without editing any file."""

from __future__ import annotations

import filecmp
import json
import re

import pytest

from annbench.registry import Registry, cell_params, form
from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
REG = Registry(REPO)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_loads_by_name(name):
    cfg = REG.config(name)
    assert {"n", "dim", "num_queries", "metric", "dtype", "generator", "assumed"} <= set(cfg)
    form(cfg)  # a form the harness takes
    assert cfg["reduced"] == [] and "data" in cfg["assumed"]
    assert "ann-benchmarks" in cfg["source"] and "Makefile" in cfg["build_source"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_traffic_loads_by_name(cell):
    cfg, traffic = REG.config(cell["config"]), REG.traffic(cell["traffic"])
    params = cell_params(cfg, traffic)
    assert params["args"]["K"] == 10 and traffic["request_queries"] == 1000
    assert {"dist_gap", "recall_floor"} <= set(params["limits"])
    if traffic["method"] == "search":
        assert {"ef_search"} <= set(params["args"]) and "set_expand_factor" in params["setters"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(metric):
    assert callable(REG.reader(metric["name"]).read)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["annbench"] and BENCH["command"][1].startswith("annbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("annbench/") and any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert len(REG.metrics(w["name"], "end_to_end")) >= 2 and REG.metrics(w["name"], "per_layer")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert all(m["moves"] in {x["name"] for x in REG.metrics(w, "end_to_end")}
                   for w in m["workloads"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"


def test_added_config_and_mix_are_found_without_editing_a_file(toy_root, toy_reg):
    cell = toy_reg.cell("toy.graph")
    cfg, traffic = toy_reg.config(cell["config"]), toy_reg.traffic(cell["traffic"])
    assert cfg["n"] == 3000 and traffic["request_queries"] == 100
    assert cell_params(cfg, traffic)["args"] == {"K": 10, "ef_search": 96}
    assert toy_reg.traffic(toy_reg.cell("toy.scan")["traffic"])["method"] == "search_exact"
    assert "toy.graph" in [w for m in toy_reg.metrics("toy.graph", "per_layer")
                           for w in m["workloads"]]
    # every file the benchmark had is as it was
    src = sorted(p.relative_to(REPO / "annbench") for p in (REPO / "annbench").rglob("*")
                 if p.is_file() and "tests" not in p.parts and "__pycache__" not in p.parts
                 and ".cache" not in p.parts)
    assert src and all(filecmp.cmp(REPO / "annbench" / p, toy_root / "annbench" / p, shallow=False)
                       for p in src)
