"""Pareto-frontier plots: recall vs QPS / latency.

A copy of flatnav_tpu/bench/plotting.py, kept here so that the port imports
nothing of the JAX package. After the reference's
experiments/plotting/plot.py (Pareto computation + figure scripts): computes the non-dominated frontier of
(recall, qps) points per (index_type, M) series and renders matplotlib
curves. matplotlib is optional; callers gate on ImportError.
"""

from __future__ import annotations

import collections
from typing import Iterable, List, Tuple


def pareto_frontier(
    points: Iterable[Tuple[float, float]], maximize_both: bool = True
) -> List[Tuple[float, float]]:
    """Non-dominated subset of (recall, qps) points, sorted by recall."""
    pts = sorted(set(points))
    frontier: List[Tuple[float, float]] = []
    best_y = float("-inf")
    for x, y in reversed(pts):  # descending recall
        if y > best_y:
            frontier.append((x, y))
            best_y = y
    return list(reversed(frontier))


def plot_pareto(
    rows: list[dict],
    out_path: str,
    x_metric: str = "recall",
    y_metric: str = "qps",
    title: str | None = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = collections.defaultdict(list)
    for row in rows:
        key = f"{row.get('index_type', 'flatnav')}-M{row.get('M', '?')}"
        series[key].append((row[x_metric], row[y_metric]))

    fig, ax = plt.subplots(figsize=(7, 5))
    for key, pts in sorted(series.items()):
        frontier = pareto_frontier(pts)
        xs = [p[0] for p in frontier]
        ys = [p[1] for p in frontier]
        ax.plot(xs, ys, marker="o", label=key)
    ax.set_xlabel(x_metric)
    ax.set_ylabel(y_metric)
    if y_metric == "qps":
        ax.set_yscale("log")
    ax.legend()
    ax.grid(True, alpha=0.3)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
