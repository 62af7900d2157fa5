"""The program's own tracer (`flatnav_tpu_torch.utils.profiling`), as the
benchmark reads it in a `--trace 1` run.

The harness's window and its profiled requests run with the tracer off, as
they ran before the program had one, so every metric they feed reads the
same program. The readers of the tracer declare the two spans `SPANS`,
whose hooks run a phase of the tracer's own on the same index, queries and
request size, `trace_requests` requests at a time:

1. when the harness makes its profiler, right after the window (span
   `UNPROFILED`), unprofiled: each request twice on the same queries, once
   with the tracer on and once off, each going first in turn: the span
   table and counters of the requests with it on
   (`search.host_ms_per_hop`, `search.dist_comps_per_query`), their
   request records (the stall split) and what tracing on costs (the median
   latency on against off);
2. when the harness has read its profiler run (`trace.summarize`, span
   `TRACE`), under a profiler of its own, with the tracer on: the
   program's `flatnav.` ranges on the trace's host timeline and the device
   operations launched inside them (`search.launches_per_hop`,
   `search.hop_idle_pct`, `scan.prepare_ms`).

The numbers go into the spans' statistics (`SpanStats.counts`) under the
keys ("span", path, field), ("counter", name), ("request", seq, field),
("stage", seq, span) for the self time of each span of a request,
("on_ms", seq), ("off_ms", j) and ("trace", name); the report goes to
stderr. `annbench/run.py` has no step for a reader's phase, so the hooks
take the request from the harness's `run_cell` frame (`call`, `q_np`,
`slices`, `params`, `traffic`, `dev`) and set its recorder's phase to
"program" meanwhile: the harness's own spans add nothing of it to the
phases they read. Where the program has no tracer, the hooks do nothing
and the readers return None.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import statistics
import sys
import time

import torch

from annbench import trace as trace_mod
from annbench.spans import Span

#: prefix of the program's ranges in a profiler trace (`profiling.PREFIX`,
#: written out: a program without the tracer has no such name)
RANGE = "flatnav."
#: a request this much slower than the phase's median is in the stall tail
STALL = 1.3
_RUN = os.path.join("annbench", "run.py")


def _profiling():
    """The program's tracer module, or None where the program has none."""
    try:
        from flatnav_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") and hasattr(profiling, "snapshot") else None


def _harness():
    """The locals of the harness's `run_cell` that the hook runs under, or
    None outside a run."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and f.f_code.co_filename.endswith(_RUN):
            return f.f_locals
        f = f.f_back
    return None


def _add(snap: dict, counts) -> None:
    """Adds one request's table (`profiling.snapshot` after it) to `counts`."""
    for path, row in snap["spans"].items():
        for field, v in row.items():
            counts[("span", path, field)] += v
    for name, v in snap["counters"].items():
        counts[("counter", name)] += v
    for r in snap["requests"]:
        for field in ("dur_ns", "wait_ns", "host_ns"):
            counts[("request", r["seq"], field)] = r[field]
        for path, row in snap["spans"].items():
            counts[("stage", r["seq"], path.rsplit("/", 1)[-1])] += row["self_ns"]


def _requests(h):
    """(request(j), n): the harness's j-th request of its mix, and how many
    requests its profiled phase makes."""
    call, q_np, slices, args = h["call"], h["q_np"], h["slices"], h["params"]["args"]

    def request(j):
        lo, hi = slices[j % len(slices)]
        call(q_np[lo:hi], **args)

    return request, h["traffic"]["trace_requests"]


@contextlib.contextmanager
def _own_phase(h):
    """The harness's recorder counts what runs in the block under the phase
    "program", which no metric of the harness reads."""
    rec = h["recorder"]
    was, rec.phase = rec.phase, "program"
    try:
        yield
    finally:
        rec.phase = was


def _unprofiled(args, kwargs, result, stats):
    prof, h = _profiling(), _harness()
    if prof is None or h is None:
        return
    request, n = _requests(h)
    with _own_phase(h):
        prof.snapshot(reset=True)
        for j in range(n):  # on, off; then off, on: neither goes first each time
            for on in (True, False) if j % 2 == 0 else (False, True):
                with prof.tracing() if on else contextlib.nullcontext():
                    t = time.perf_counter()
                    request(j)
                    ms = (time.perf_counter() - t) * 1e3
                if on:
                    snap = prof.snapshot(reset=True)
                    _add(snap, stats.counts)
                    stats.counts[("on_ms", snap["seq"])] = ms
                else:
                    stats.counts[("off_ms", j)] = ms


def _profiled(args, kwargs, summary, stats):
    prof, h = _profiling(), _harness()
    if prof is None or h is None:
        return
    request, n = _requests(h)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if h["dev"].type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # the class itself: `torch.profiler.profile` is the span `UNPROFILED`
    p = torch.profiler.profiler.profile(activities=acts)
    with _own_phase(h), prof.tracing():
        p.start()
        for j in range(n):
            with torch.profiler.record_function(trace_mod.REQUEST):
                request(j)
        if h["dev"].type == "cuda":
            torch.cuda.synchronize(h["dev"])
        p.stop()
    prof.snapshot(reset=True)
    for name, v in read_ranges(p).items():
        stats.counts[("trace", name)] = v
    rec = h["recorder"]
    counts = collections.Counter(stats.counts)
    counts.update(rec.stats["trace"][UNPROFILED.name].counts)
    report(counts, summary, rec.stats["program"].get("search"))


#: the harness's profiler, made right after the window: before it starts,
#: the unprofiled requests of the program phase run (once a profiler has
#: recorded in a process, the host-bound graph requests there ran 15-20%
#: slower on an H100 machine, the scans' not)
UNPROFILED = Span("program.unprofiled", "torch.profiler", "profile", observe=_unprofiled)
#: the harness's reading of its profiler run, after which the program
#: phase's profiled requests run
TRACE = Span("program", "annbench.trace", "summarize", observe=_profiled)
SPANS = [UNPROFILED, TRACE]


def _in(iv, starts, at) -> bool:
    """Whether `at` lies in one of the sorted, disjoint intervals `iv`."""
    i = bisect.bisect_right(starts, at) - 1
    return i >= 0 and at <= iv[i][1]


def read_ranges(prof) -> dict:
    """The program's spans in a profiler run of the profiled requests, as
    {name: number}: for each program span S, "ops.S" and "ms.S" (device
    operations launched inside its ranges, and their device time) and
    "ranges.S"; "idle_s.S", the idle time of the window whose gap opens with
    S the innermost program span open (S = "python": none); "window_s",
    "busy_s" and "requests" as `trace.summarize` has them; and the shares
    that say whether the program's ranges cover the work: "search_ops" and
    "search_ops_in_program" (operations launched inside the harness's
    `search` span, and of those inside a `flatnav.search*` range),
    "search_idle_s" and "search_idle_named_s" (idle time whose gap opens
    inside that span, and of it under a named program span),
    "request_ops" and "request_ops_in_program" (the same for whole
    requests and any program range)."""
    events = prof.profiler.kineto_results.events()
    host, device, launch_at, op_start = [], [], {}, {}
    for e in events:
        if trace_mod._is_device(e):
            if not e.name().startswith(RANGE):
                device.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            if trace_mod._is_runtime(e):
                launch_at[e.correlation_id()] = e.start_ns()
            else:
                host.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
                op_start[e.correlation_id()] = e.start_ns()
    requests = sorted((s, t) for s, t, name, _ in host if name == trace_mod.REQUEST)
    out = collections.Counter()
    if not requests:
        return {}
    w0, w1 = requests[0][0], max(t for _, t in requests)
    out["requests"] = len(requests)
    out["window_s"] = (w1 - w0) / 1e9
    busy = trace_mod._merge([max(s, w0), min(t, w1)] for s, t, *_ in device if t > w0 and s < w1)
    out["busy_s"] = sum(t - s for s, t in busy) / 1e9

    main = collections.Counter(
        tid for _, _, name, tid in host if name == trace_mod.REQUEST).most_common(1)[0][0]
    ranges = collections.defaultdict(list)  # span -> [(start, end)], any thread
    for s, t, name, tid in host:
        if name.startswith(RANGE):
            ranges[name[len(RANGE):]].append((s, t))
    harness = {name: trace_mod._merge([s, t] for s, t, n, _ in host if n == name)
               for name in (trace_mod.PREFIX + "search", trace_mod.REQUEST)}
    program_search = trace_mod._merge(
        [s, t] for span, iv in ranges.items() if span.split(".")[0] == "search" for s, t in iv)
    program_any = trace_mod._merge([s, t] for iv in ranges.values() for s, t in iv)
    at_of = [launch_at.get(corr, op_start.get(linked)) for _, _, corr, linked in device]

    for span, iv in ranges.items():
        out["ranges." + span] = len(iv)
        merged = trace_mod._merge([s, t] for s, t in iv)
        starts = [s for s, _ in merged]
        for (s, t, *_), at in zip(device, at_of):
            if at is not None and _in(merged, starts, at):
                out["ops." + span] += 1
                out["ms." + span] += (t - s) / 1e6
    for key, inner, outer in (("search_ops", program_search, trace_mod.PREFIX + "search"),
                              ("request_ops", program_any, trace_mod.REQUEST)):
        o_iv, i_iv = harness[outer], inner
        o_st, i_st = [s for s, _ in o_iv], [s for s, _ in i_iv]
        for at in at_of:
            if at is not None and _in(o_iv, o_st, at):
                out[key] += 1
                out[key + "_in_program"] += _in(i_iv, i_st, at)

    gaps, edge = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    main_ranges = [(s, t, name[len(RANGE):]) for s, t, name, tid in host
                   if tid == main and name.startswith(RANGE)]
    names = trace_mod._innermost(main_ranges, [s for s, _ in gaps])
    s_iv = harness[trace_mod.PREFIX + "search"]
    s_st = [s for s, _ in s_iv]
    for (s, t), name in zip(gaps, names):
        out["idle_s." + name] += (t - s) / 1e9
        if _in(s_iv, s_st, s):
            out["search_idle_s"] += (t - s) / 1e9
            out["search_idle_named_s"] += (t - s) / 1e9 if name != "python" else 0.0
    return dict(out)


def table(ctx) -> collections.Counter:
    """The program phase's numbers in a run, empty where it had none."""
    out = collections.Counter()
    for phase in ("trace", "replay"):
        for span in SPANS:
            st = (ctx.spans or {}).get(phase, {}).get(span.name)
            if st is not None:
                out.update(st.counts)
    return out


def profiled(ctx) -> dict:
    """`read_ranges` of the program phase's profiled requests; {} where the
    program has no ranges or no operation ran on a device (a CPU run)."""
    got = {k[1]: v for k, v in table(ctx).items() if k[0] == "trace"}
    return got if got.get("busy_s") else {}


def span_sums(counts, name: str) -> dict:
    """calls and total / self / wait ns of every span `name` in a table,
    wherever it nests."""
    out = collections.Counter()
    for key, v in counts.items():
        if key[0] == "span" and key[1].rsplit("/", 1)[-1] == name:
            out[key[2]] += v
    return out


def hop_idle_s(found: dict) -> float:
    """Idle time whose gap opens inside `search.hop` or one of its stages."""
    return sum(v for k, v in found.items()
               if k == "idle_s.search.hop" or k.startswith("idle_s.search.hop."))


def _stall_lines(counts) -> list[str]:
    seqs = sorted(k[1] for k in counts if k[0] == "on_ms")
    if not seqs or any(("request", s, "dur_ns") not in counts for s in seqs):
        return [f"program stall tail: {len(seqs)} requests with the tracer on, not split"]
    rows = [(counts[("on_ms", s)], counts[("request", s, "wait_ns")] / 1e6,
             counts[("request", s, "host_ns")] / 1e6,
             counts[("on_ms", s)] - counts[("request", s, "dur_ns")] / 1e6) for s in seqs]
    med = [statistics.median(c) for c in zip(*rows)]
    slow = [i for i, r in enumerate(rows) if r[0] > STALL * med[0]]
    if not slow:
        return [f"program stall tail: none of {len(rows)} requests over {STALL}x the median"]
    excess = [statistics.fmean(rows[i][c] for i in slow) - med[c] for c in range(4)]
    by_stage = sorted(
        ((statistics.fmean(counts[("stage", seqs[i], g)] for i in slow)
          - statistics.median(counts[("stage", s, g)] for s in seqs)) / 1e6, g)
        for g in {k[2] for k in counts if k[0] == "stage"})[::-1]
    return [f"program stall tail: {len(slow)} of {len(rows)} requests over {STALL}x the "
            f"median {med[0]:.3f} ms; their mean excess {excess[0]:.3f} ms = wait "
            f"{excess[1]:.3f} + host in spans {excess[2]:.3f} + outside the program "
            f"{excess[3]:.3f} (medians: wait {med[1]:.3f}, host {med[2]:.3f}, "
            f"outside {med[3]:.3f}); by span's self time, ms: "
            + ", ".join(f"{g} {v:.3f}" for v, g in by_stage[:6])]


def report(counts, summary, search) -> None:
    """Prints the program phase's span table and counters, what tracing on
    cost, the stall tail's split and the profiled requests' program ranges
    on stderr. `summary` is the harness's reading of its own profiler run,
    `search` its `search` span's statistics of the program phase."""
    found = {k[1]: v for k, v in counts.items() if k[0] == "trace"}
    lines = ["program spans, tracer on, unprofiled: path, calls, total / self / wait ms"]
    for key in sorted(k for k in counts if k[0] == "span" and k[2] == "calls"):
        path = key[1]
        lines.append(f"  {path}: {counts[key]}, " + " / ".join(
            f"{counts[('span', path, f)] / 1e6:.3f}" for f in ("total_ns", "self_ns", "wait_ns")))
    lines.append("program counters: " + ", ".join(
        f"{k[1]} {v}" for k, v in sorted((k, v) for k, v in counts.items() if k[0] == "counter")))
    if search is not None and search.counts["queries"] and counts[("counter", "search.queries")]:
        lines.append(
            f"program search.hops / search.queries {counts[('counter', 'search.hops')] / counts[('counter', 'search.queries')]:.6f}"
            f", the harness's hops / queries {search.counts['hops'] / search.counts['queries']:.6f}")
    on = [v for k, v in counts.items() if k[0] == "on_ms"]
    off = [v for k, v in counts.items() if k[0] == "off_ms"]
    if on and off:
        a, b = statistics.median(on), statistics.median(off)
        lines.append(f"program tracing on: median request {a:.4f} ms against {b:.4f} ms off "
                     f"over {len(on)} pairs on the same queries ({100 * (a / b - 1):+.2f}%)")
    lines += _stall_lines(counts)
    if found.get("requests"):
        lines.append(f"program ranges in {found['requests']} profiled requests: window "
                     f"{found['window_s']:.6f} s, busy {found['busy_s']:.6f} s (the harness's "
                     f"own profiled requests: window {summary.window_s:.6f} s, busy "
                     f"{summary.busy_s:.6f} s)")
        if found.get("search_ops"):
            lines.append(
                f"  search: {found['search_ops_in_program']} of {found['search_ops']} operations "
                f"launched inside flatnav.search*; {found['search_idle_named_s']:.6f} of "
                f"{found['search_idle_s']:.6f} s idle under a named program span")
        if found.get("request_ops"):
            lines.append(f"  requests: {found['request_ops_in_program']} of "
                         f"{found['request_ops']} operations launched inside a flatnav. range")
        for span in sorted(k[4:] for k in found if k.startswith("ops.")):
            lines.append(f"  {span}: {found.get('ranges.' + span, 0)} ranges, "
                         f"{found['ops.' + span]} operations, {found['ms.' + span]:.3f} ms")
        idle = sorted(((v, k[7:]) for k, v in found.items() if k.startswith("idle_s.")),
                      reverse=True)
        lines.append("  idle by innermost program span, s: " + ", ".join(
            f"{name} {v:.4f}" for v, name in idle[:12]))
    for line in lines:
        print(line, file=sys.stderr)
