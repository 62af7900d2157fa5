"""Benchmark metric registry (numpy only).

A copy of flatnav_tpu/bench/metrics.py, kept here so that the port imports
nothing of the JAX package. The reference's MetricManager
(experiments/plotting/metrics.py:7-132): a registry of
named metric functions computed from (requires) {index, results, timings,
ground_truth, config}. Registered metrics match the reference's set:
recall, qps, latency percentiles p50/p90/p95/p99/p999, distance
computations per query, index size, build time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np


@dataclasses.dataclass
class MetricContext:
    index: object | None = None
    found_labels: np.ndarray | None = None  # [nq, k]
    ground_truth: np.ndarray | None = None  # [nq, >=k]
    latencies_s: np.ndarray | None = None  # per query: its dispatch's wall time
    total_seconds: float | None = None
    num_queries: int | None = None
    distance_computations: int | None = None
    build_seconds: float | None = None


class MetricManager:
    def __init__(self):
        self._metrics: Dict[str, Callable[[MetricContext], float]] = {}

    def register(self, name: str):
        def deco(fn):
            self._metrics[name] = fn
            return fn

        return deco

    def compute(self, names: List[str], ctx: MetricContext) -> dict:
        return {n: self._metrics[n](ctx) for n in names}

    @property
    def available(self) -> List[str]:
        return sorted(self._metrics)


metric_manager = MetricManager()


def recall_at_k(found: np.ndarray, truth: np.ndarray) -> float:
    """recall@k over the columns BOTH sides actually have: when the
    ground-truth file stores fewer neighbors than k, clamping only the
    truth side would let any superset score 1.0 — clamp both (the shared
    definition; tools/query.py uses this too)."""
    k = min(found.shape[1], truth.shape[1])
    found, truth = found[:, :k], truth[:, :k]
    hits = sum(
        len(set(f.tolist()) & set(t.tolist()))
        for f, t in zip(found, truth)
    )
    return hits / truth.size


@metric_manager.register("recall")
def recall(ctx: MetricContext) -> float:
    return recall_at_k(ctx.found_labels, ctx.ground_truth)


@metric_manager.register("qps")
def qps(ctx: MetricContext) -> float:
    return ctx.num_queries / ctx.total_seconds


def _latency_percentile(p: float):
    def fn(ctx: MetricContext) -> float:
        return float(np.percentile(ctx.latencies_s, p) * 1000.0)  # ms

    return fn


for _p, _name in (
    (50, "latency_p50"),
    (90, "latency_p90"),
    (95, "latency_p95"),
    (99, "latency_p99"),
    (99.9, "latency_p999"),
):
    metric_manager.register(_name)(_latency_percentile(_p))


@metric_manager.register("distance_computations")
def distance_computations(ctx: MetricContext) -> float:
    return ctx.distance_computations / max(ctx.num_queries, 1)


@metric_manager.register("index_size")
def index_size(ctx: MetricContext) -> float:
    return float(ctx.index.index_memory_bytes())


@metric_manager.register("build_time")
def build_time(ctx: MetricContext) -> float:
    return float(ctx.build_seconds)
