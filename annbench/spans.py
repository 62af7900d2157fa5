"""The benchmark's spans: wrappers around the calls the program makes into
each layer, installed for a `--trace 1` run only.

A `Span` names a function by the module attribute through which the
program calls it. While installed, each call runs inside a
`torch.profiler.record_function("annbench.<name>")` range (so the trace can
attribute device kernels to it) and adds to the span's statistics of the
current phase: calls, host seconds, the bound of the call where the span has
one, and what its `observe` hooks count. Phases: "window" (the measured
requests), "trace" (the profiled requests) and "replay" (the profiled
requests again, for bounds that must read device data, such as K2's count of
distinct rows, which would perturb the profiled calls). Metric readers
declare the spans they read in `SPANS`.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import time
from typing import Callable

import torch

from annbench import bounds


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    module: str
    attr: str
    observe: Callable | None = None  # (args, kwargs, result, stats) -> None
    bound: Callable | None = None  # (*args, **kwargs) -> ms
    replay: bool = False  # the bound is taken in the replay phase


@dataclasses.dataclass
class SpanStats:
    calls: int = 0
    seconds: float = 0.0
    bound_ms: float = 0.0
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)


def _count_search(args, kwargs, result, stats):
    stats.counts["hops"] += int(result.hops)
    stats.counts["queries"] += int(args[4].shape[0])


#: `Index.search`'s batched beam search (index/search.py), as api.py calls it
SEARCH = Span("search", "flatnav_tpu_torch.index.api", "batched_search", observe=_count_search)
#: K2, as the hop calls it (one call a hop)
K2 = Span("k2", "flatnav_tpu_torch.index.search", "gather_distances",
          bound=bounds.gather_call, replay=True)
#: K1, as `fused_knn` calls it
K1 = Span("k1", "flatnav_tpu_torch.ops.fused_scan", "scan_buckets", bound=bounds.scan_call)
#: K3, as `smallest_k` (phase B of `fused_knn`) calls it
K3 = Span("k3", "flatnav_tpu_torch.ops.distances", "select_k", bound=bounds.select_call)


class _Wrapped:
    """Stands in for a function at its module attribute. Attribute reads and
    writes pass through, so the function's own counters (`fn.launches += 1`
    through its module's name) keep counting on the function."""

    def __init__(self, fn, name, spans, recorder):
        object.__setattr__(self, "_w", (fn, name, spans, recorder))

    def __getattr__(self, attr):
        return getattr(object.__getattribute__(self, "_w")[0], attr)

    def __setattr__(self, attr, value):
        setattr(self._w[0], attr, value)

    def __call__(self, *args, **kwargs):
        fn, name, spans, rec = self._w
        t0 = time.perf_counter()
        with torch.profiler.record_function("annbench." + name):
            out = fn(*args, **kwargs)
        st = rec.stats[rec.phase][name]
        st.calls += 1
        st.seconds += time.perf_counter() - t0
        for sp in spans:
            if sp.observe is not None:
                sp.observe(args, kwargs, out, st)
            if sp.bound is not None and rec.phase == ("replay" if sp.replay else "trace"):
                st.bound_ms += sp.bound(*args, **kwargs)
        return out


class Recorder:
    """Installs `spans` (one wrapper a module attribute) and keeps their
    statistics by phase; `restore` puts the functions back."""

    def __init__(self, spans):
        self.by_attr: dict[tuple[str, str], list[Span]] = {}
        for sp in spans:
            same = self.by_attr.setdefault((sp.module, sp.attr), [])
            if same and same[0].name != sp.name:
                raise ValueError(f"{sp.module}.{sp.attr} spanned as {same[0].name} and {sp.name}")
            if sp not in same:
                same.append(sp)
        self.stats = collections.defaultdict(lambda: collections.defaultdict(SpanStats))
        self.phase = "setup"
        self._saved = []

    @property
    def names(self) -> list[str]:
        return [group[0].name for group in self.by_attr.values()]

    @property
    def replays(self) -> bool:
        """Whether a span takes its bound in the replay phase."""
        return any(sp.replay for group in self.by_attr.values() for sp in group)

    def install(self):
        for (module, attr), group in self.by_attr.items():
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, _Wrapped(fn, group[0].name, group, self))

    def restore(self):
        while self._saved:
            mod, attr, fn = self._saved.pop()
            setattr(mod, attr, fn)
