"""Runs one cell of the benchmark once, on the card, and prints its result.

    python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (its file of sizes, `configs/`) and a traffic
mix (`traffic/<name>.json`) in `BENCHMARK.json`. A run:

1. draws the configuration's rows and test queries on the card from `--seed`,
   in its form (`registry.form`: its metric and the type of its rows;
   `synth.py`), copies them to the host and frees the card;
2. sets up the program (`flatnav_tpu_torch`), its index created with the
   configuration's metric and type (`registry.index_args`), as the mix
   says: `Index.add` (the graph build) or `Index.allocate_nodes` (rows
   only), then the mix's
   setters, then `warmup_passes` passes of its requests, so that every
   kernel is built and every shape seen before the clock starts;
3. measures a closed loop with one client for `--seconds`: requests of
   `request_queries` test queries, the test set in turn, each one call of
   the mix's `method` timed on the host from the call until its ids and
   distances are on the host;
4. with `--trace 1`, records the benchmark's spans (`spans.py`) over the
   window and then profiles `trace_requests` more requests with
   `torch.profiler` (`trace.py`);
5. reads the card's peak memory, frees the program, and judges every answer
   of the window against the plain reference (`check.py`);
6. prints each compared number beside its limit as the last lines of
   standard error, and one JSON line as the last line of standard output:
   the cell's `end_to_end` metrics (`--trace 0`) or its `per_layer`
   metrics (`--trace 1`), each computed by its reader in `metrics/`.

It exits nonzero and prints no result without enough CUDA cards, and when
JAX or the JAX package has been loaded. Build outputs stay in the checkout
(`flatnav_tpu_torch/_build/`, and CUDA's and Triton's caches under
`annbench/.cache/`).
"""

import time

_T0 = time.time()  # process start, as near as the harness can read it

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names the port must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "flatnav_tpu")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    setup_s: float = 0.0
    build_s: float | None = None
    window_s: float = 0.0
    queries: int = 0  # answered in the window
    latencies_s: list = dataclasses.field(default_factory=list)
    recall: float | None = None
    peak_bytes: int | None = None
    spans: dict | None = None  # phase -> span -> SpanStats
    trace: object | None = None  # trace.TraceSummary


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _gc_counts() -> list[int]:
    return [g["collections"] for g in gc.get_stats()]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(reg, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = _T0) -> dict:
    """One run of cell `name` -> the result line's object. `device="cpu"`
    runs the program on the CPU, for tests at toy sizes."""
    import numpy as np
    import torch

    from annbench import check, spans as spans_mod, synth
    from annbench import trace as trace_mod
    from annbench.registry import cell_params, form, index_args

    cell = reg.cell(name)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    params = cell_params(cfg, traffic)
    k = params["args"]["K"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ctx = Context()
    wanted = reg.metrics(name, "per_layer" if trace else "end_to_end")
    readers = {m["name"]: reg.reader(m["name"]) for m in wanted}

    marks = [("start", time.time() - t0)]
    data, queries = synth.generate(cfg, seed, dev)
    data_np, q_np = data.cpu().numpy(), queries.cpu().numpy()
    del data, queries
    gen_peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    marks.append(("data", time.time() - t0))
    import flatnav_tpu_torch

    index = flatnav_tpu_torch.index.create(**index_args(cfg), device=device)
    tb = time.perf_counter()
    if traffic["setup"] == "add":
        index.add(data_np, ef_construction=cfg["ef_construction"])
        _sync(dev)
        ctx.build_s = time.perf_counter() - tb
    elif traffic["setup"] == "allocate_nodes":
        index.allocate_nodes(data_np)
    else:
        raise ValueError(f"unknown setup {traffic['setup']!r}")
    for setter, value in params["setters"].items():
        getattr(index, setter)(value)
    call = getattr(index, traffic["method"])
    marks.append(("program set-up", time.time() - t0))
    rq = traffic["request_queries"]
    slices = [(lo, min(lo + rq, len(q_np))) for lo in range(0, len(q_np), rq)]

    recorder = spans_mod.Recorder(
        [sp for r in readers.values() for sp in getattr(r, "SPANS", [])])
    recorder.install()
    # answers kept as flat lists of ints and arrays: no tuple a request for
    # the garbage collector to walk while the window runs
    los, dists, idss, missing, failed, attempted = [], [], [], 0, 0, 0
    try:
        for _ in range(traffic["warmup_passes"]):
            for lo, hi in slices:
                call(q_np[lo:hi], **params["args"])
        _sync(dev)
        ctx.setup_s = time.time() - t0
        marks.append(("warm-up", ctx.setup_s))
        print("set-up ends (s after process start): "
              + ", ".join(f"{m} {v:.3f}" for m, v in marks), file=sys.stderr)

        recorder.phase = "window"
        ends = []  # seconds into the window of each answer
        by_slice = [[] for _ in slices]  # latencies of each request slice
        # set-up's objects out of the collector's reach: a full collection in
        # the window walks only what the window made
        gc.collect()
        gc.freeze()
        gc0, ru0, cpu0 = _gc_counts(), resource.getrusage(resource.RUSAGE_SELF), time.thread_time()
        i, t_start = 0, time.perf_counter()
        t_end = t_start
        while i == 0 or time.perf_counter() - t_start < seconds:
            lo, hi = slices[i % len(slices)]
            i += 1
            attempted += hi - lo
            t = time.perf_counter()
            try:
                d, ids = call(q_np[lo:hi], **params["args"])
            except Exception as e:  # a failed request is counted and judged, not fatal
                failed += hi - lo
                missing += hi - lo
                print(f"annbench: request {i} raised {e!r}", file=sys.stderr)
                continue
            t_end = time.perf_counter()
            ctx.latencies_s.append(t_end - t)
            by_slice[(i - 1) % len(slices)].append(t_end - t)
            ends.append(t_end - t_start)
            if len(ids) != hi - lo:
                missing += hi - lo
                continue
            ctx.queries += hi - lo
            los.append(lo)
            dists.append(d)
            idss.append(ids)
        ctx.window_s = t_end - t_start
        ran, ru1 = time.thread_time() - cpu0, resource.getrusage(resource.RUSAGE_SELF)
        print(f"window host: the loop's thread ran {100 * ran / max(ctx.window_s, 1e-9):.1f}% "
              f"of {ctx.window_s:.3f} s, {ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary switches, "
              "collections by generation " + "/".join(
                  str(b - a) for a, b in zip(gc0, _gc_counts())), file=sys.stderr)
        fifth = ctx.window_s / 5
        print("window qps by fifths: " + ", ".join(
            f"{rq * sum(j * fifth < t <= (j + 1) * fifth for t in ends) / fifth:.1f}"
            for j in range(5)), file=sys.stderr)
        if ctx.latencies_s:
            print("window latency ms: " + ", ".join(
                f"p{q} {v * 1e3:.3f}" for q, v in zip(
                    (50, 90, 95, 99, 100), np.percentile(ctx.latencies_s, (50, 90, 95, 99, 100))))
                + "; median by slice: " + ", ".join(
                    f"{np.median(v) * 1e3:.2f}" for v in by_slice if v), file=sys.stderr)
        ctx.peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else None

        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            n_trace = traffic["trace_requests"]
            recorder.phase = "trace"
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            for j in range(n_trace):
                lo, hi = slices[j % len(slices)]
                with torch.profiler.record_function(trace_mod.REQUEST):
                    call(q_np[lo:hi], **params["args"])
            _sync(dev)
            prof.stop()
            if recorder.replays:
                recorder.phase = "replay"
                for j in range(n_trace):
                    lo, hi = slices[j % len(slices)]
                    call(q_np[lo:hi], **params["args"])
            ctx.trace = trace_mod.summarize(prof)
            del prof
            for sp in recorder.names:
                st = recorder.stats["trace"][sp]
                print(f"trace {sp}: {st.calls} calls, "
                      f"{ctx.trace.span_device_ops.get(sp, 0)} device operations in "
                      f"{ctx.trace.span_device_ms.get(sp, 0.0):.3f} ms, bound "
                      f"{st.bound_ms + recorder.stats['replay'][sp].bound_ms:.3f} ms",
                      file=sys.stderr)
    finally:
        gc.unfreeze()
        recorder.restore()
    ctx.spans = recorder.stats

    del index, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    data = torch.from_numpy(data_np).to(dev)
    queries = torch.from_numpy(q_np).to(dev)
    correct, numbers, ctx.recall = check.judge(
        data, queries, list(zip(los, dists, idss)), k, form(cfg)[0], params["limits"], missing=missing)
    del data, queries

    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peaks = [p for p in (gen_peak, ctx.peak_bytes) if p is not None]
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": cell["chips"],
        "memory_peak_bytes": max(peaks) if peaks else 0,
    }
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["check"] = {n: {"value": v, "limit": lim, "op": op}
                       for n, (v, lim, op) in numbers.items()}
    for line in check.lines(numbers):
        print(line, file=sys.stderr)
    print(f"check correct: {bool(correct)}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "annbench" / ".cache"
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    from annbench.registry import Registry

    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    import torch

    # one thread for the host's torch operations: the window's host work is
    # launches and small copies, and idle pool threads only compete for cores
    torch.set_num_threads(1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"annbench: {args.workload} needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"annbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
