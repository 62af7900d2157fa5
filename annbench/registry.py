"""Finds what a cell names, by name, so that a configuration, a traffic mix or
a metric is added as new files and entries without editing any file here.

- a cell, a configuration and the metrics: `BENCHMARK.json` at the root of
  the checkout (the configuration's `file` is its file of sizes);
- a traffic mix: `traffic/<name>.json` beside this module; what of its call
  belongs to the deployment (a graph mix's operating point) sits in the
  configuration's file, in the group that the mix names (`cell_params`);
- a metric: its reader, `metrics/<name>.py` beside this module, a module
  with `read(ctx) -> float | None` and, where it reads spans, `SPANS`;
- a configuration's data form: `metric` and `dtype` in its file (`form`),
  which the generator, the program's index (`index_args`) and the
  reference all take from here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path | str | None = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.here = self.root / HERE.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                if cfg.get("name") != name:
                    raise ValueError(f"{c['file']} names {cfg.get('name')!r}, not {name!r}")
                return cfg
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        t = json.loads((self.here / "traffic" / f"{name}.json").read_text())
        if t.get("name") != name:
            raise ValueError(f"traffic/{name}.json names {t.get('name')!r}")
        return t

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics that `cell` reports: those
        whose `workloads` name it, or that have no `workloads`."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"annbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def cell_params(cfg: dict, traffic: dict) -> dict:
    """The mix's call for this configuration: the mix's `args`, `setters` and
    `limits`, with those of the configuration's group that the mix names in
    `config_group` laid over them (a graph mix's operating point and recall
    floor, which belong to the deployment)."""
    own = cfg[traffic["config_group"]] if "config_group" in traffic else {}
    return {key: {**traffic.get(key, {}), **own.get(key, {})}
            for key in ("args", "setters", "limits")}


#: the data forms the harness takes: `metric` (l2: squared L2; angular: unit
#: rows scored by 1 - <q, x>) and `dtype`, the type of the rows as served
METRICS = ("l2", "angular")
DTYPES = ("float32", "uint8", "int8")


def form(cfg: dict) -> tuple[str, str]:
    """The configuration's (metric, dtype), read from its file. The one place
    that reads them: the generator (`synth.generate`), the program's index
    (`index_args`) and the comparison (`check.judge`, through the caller) all
    take the form from here. Raises, naming the key, on a value the harness
    does not take."""
    name = cfg.get("name")
    metric, dtype = cfg.get("metric"), cfg.get("dtype")
    if metric not in METRICS:
        raise ValueError(f"configuration {name!r}: key 'metric' is {metric!r}, not one of {METRICS}")
    if dtype not in DTYPES:
        raise ValueError(f"configuration {name!r}: key 'dtype' is {dtype!r}, not one of {DTYPES}")
    if metric == "angular" and dtype != "float32":
        raise ValueError(f"configuration {name!r}: key 'dtype' is {dtype!r}; angular rows are "
                         "unit float32 rows, which have no 8-bit form here")
    return metric, dtype


def index_args(cfg: dict) -> dict:
    """The keywords of the program's `flatnav_tpu_torch.index.create` for the
    configuration: its metric, sizes and `index_data_type` from its `dtype`."""
    from flatnav_tpu_torch.data_type import DataType

    metric, dtype = form(cfg)
    return {"distance_type": metric, "dim": cfg["dim"], "dataset_size": cfg["n"],
            "max_edges_per_node": cfg["max_edges_per_node"],
            "index_data_type": DataType(dtype)}
