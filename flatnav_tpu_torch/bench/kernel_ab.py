"""Kernels of this checkout against another version's, alternating on the card.

    python -m flatnav_tpu_torch.bench.kernel_ab --baseline DIR [DIR ...] [--reps 10] [--cases k2,k1]
    python -m flatnav_tpu_torch.bench.kernel_ab --cases k3 [--baseline DIR] [--k3 phaseB-1M,...]
    python -m flatnav_tpu_torch.bench.kernel_ab --cases hop [--hop sift,gist,glove,wave] [--baseline DIR]

DIR holds the other version's `gather_distance.cu`, `fused_scan.cu` and/or
`select_k.cu`,
for example another commit's (`git archive <commit> flatnav_tpu_torch/csrc |
tar -x -C <dir>`). Each is built by nvcc with this checkout's flags and called
through the C entry its own source declares: the parameter list is read from
its `extern "C"` line and the arguments are passed by name, so an entry with
parameters in another order, or one more that this script knows (K1's
`variant`, given what the wrapper would pick), is called correctly, and one
with a parameter this script does not know is refused. This checkout's
kernels are called through their wrappers (`gather_distances`,
`scan_buckets`). Every case is timed with CUDA events (`measure.timed`: the
mean of `--reps` calls after one warm-up call) in the order base, new, ...,
new, base, so a drift of the card's clocks shows as a difference between the
two readings of one kernel. Further DIRs after the first are K1 copies
timed beside it (`--cases k1`: each its own "baseN" line, e.g. copies of
this source with one design choice changed or one part taken out); their
results are printed against the first's, which alone this checkout's are
held to; K2 and K3 take the first DIR.

Cases, at the main path's shapes, the 1M scan's and the north-star shapes:
  K2 (`--k2`, `K2_CASES`): hop (B=1024, C=512, d=128 float32 over 100,000
  rows, random ids), wave (B=8192, C=1024, d=128: a build wave), bf16-hop
  (the hop on a bfloat16 table), hops of B=1024, C=512 over 20,000 float32
  rows at d=1536, 3072, 4096 and 8192 (OpenAI's widths and the carry-stack
  path), wave-1536 (B=8192, C=1024 over 100,000 rows of d=1536); each held
  bit-equal to the plain version in chunks of queries, and both versions
  timed through their C entries (this checkout's wrapper adds host work
  about as long as a d=128 hop)
  K1 (`--k1`, `K1_CASES`): 1M (4096 queries x 1,000,000 rows, d=128 bf16,
  T=2048, L=16), path (1024 x 108,192 rows, 100,000 valid), gist (d=960),
  angular (d=100, padded to 104 for this checkout), u8-10M (uint8 rows and
  queries, 10,000,000 rows, T=32768, L=256), u8-100M (512 queries),
  u8-10M-bf16q (u8-10M with bf16 queries: "wgmma_mixed", the parent's
  "mma"), spacev-10M and spacev-100M (MS SPACEV's int8 d=100, L2, as
  u8-10M / u8-100M), spacev-10M-bf16q (spacev-10M with bf16 queries:
  "wgmma_mixed" by the packed copies) and
  glove-25 / glove-50 (1,183,514 normalised rows, IP, 4096 queries, padded
  to 32 / 56 columns for the kernel; T=4096, L=32), openai-1536 and
  openai-3072 (1,000,000 normalised rows, IP, 4096 queries: OpenAI's
  embedding widths, "wgmma_deep"). T and L are those `fused_knn` picks.
  An entry without a query type (an older one) gets bf16 queries and unpadded
  rows, as its `fused_knn` gave it; one with `q_type` gets this
  checkout's operands and variant, so a copy of this source with a
  constant changed (e.g. `wide_scan::CS`, `wgmma_scan::STAGES`) is timed
  against this one. Where it refuses that variant (a parent that predates
  it), it gets what its own `fused_knn` gave its "mma": the same rows and
  bf16 queries. `--also VARIANT,...` also times this checkout's kernel
  launched as each named variant whose rule admits the case's operands.
Each line gives the bound (`measure.gather_bound` / `measure.scan_bound`,
at the table's d before any padding) and, for K1, the plain version's time
and the time of torch.matmul bf16 (also on a copy padded with zero columns
to a multiple of 8 where d is not one, as `fused_knn` pads bf16 copies;
and torch._int_mm for 8-bit rows, with d padded to a multiple of 8) on the
same inputs.

K3 (`--cases k3`) at its callers' shapes (`K3_CASES`, and `K3_SEEDED`:
a scan's tile merged into its running k; `--k3` picks them): `select_k`
held bit-equal to `select_k_plain`, then timed in turns with `torch.topk`
of the float keys alone (a yardstick that fixes no order among ties, so not
the same function) and, with `--baseline`, the other version's
`select_k.cu`, driven as its wrapper drove it (`base_select`: the wrapper's
rounds, `run_rounds`, and for a seeded case the tile's k and then the merge
over the concatenated 2k, two launches); a seeded case also times this
checkout's kernel in that two-launch form ("K3 two launches"); then the
plain version once, and `measure.select_bound`. The last line is every K3 case as one JSON object.

Hop (`--cases hop`, `HOP_CASES`: the sift1m.graph, gist1m.graph and
glove100.graph cells' searches at B=1000, ef 512 / E 64, ef 192 / E 16 and
ef 1536 / E 64, M=32, and a build wave at B=8192, ef 100, E 16): the hop's
bookkeeping by `ops.beam_hop`'s three
kernels beside the PyTorch chain they replace, on one synthetic mid-search
hop (`_hop_state`), held bit-equal first; no baseline. The new distances are
drawn like the beam's, so about half the fresh candidates beat the beam's
last entry and the merge sorts many more than in a real search's later
hops: its reading is an upper end. `measure.hop_bound` bounds the whole
hop, and each stage is read against its own bound
(`measure.hop_stage_bounds`). The last line is every hop case as one JSON
object. Then K2 at the three cells' hops (`k2_hop_cases`): on the hop's
full candidate ids and on its score ids (-1 where not fresh), with the
cell's share of fresh candidates, rows and d; with `--baseline`, the other
version's K2 on both too. The next line is those cases as one JSON object.
Then a hop issued as the search issued it before its hop was captured (the
kernels' select, `torch.index_select` of a random links table, membership
and merge: four launches from the host, and the end test's flag read)
against one replay of the captured hop (`index.search._HopGraphs`' step:
the merge, which also stamps the host's copy of the flag, then the next
hop's select, links gather and membership), at the four shapes (`hop_graph_cases`): the host's
time to issue each and the card's time to run it (CUDA events, the card held
by a spin kernel while the host issues, so its reading has no gap), held
bit-equal first. Its line is one JSON object. Then whole searches in
sequences of requests whose shapes change (`hop_policy_cases`, on a 100,000
x 128 clustered index at sift1m.graph's ef 512 / E 64): 1- to 16-query
requests ("mixed"), 1,000-query requests that the memory guard splits
into 300, 300, 300 and 100 ("split") and 1,000-query requests ("fixed"),
each as the search runs them (a shape captured the second time in a row
that the card searches it, one kept) against the eager loop alone; wall
ms a request, the card synchronised after each, and the shapes captured.
Its line is one JSON object.
`hop_lockstep` holds the kernels to the chain after every stage of every
hop of a whole search (the `gpu` tests and chip_smoke.py call it).
Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.bench.measure import (
    card,
    gather_bound,
    hop_bound,
    hop_stage_bounds,
    scan_bound,
    select_bound,
    timed,
)
from flatnav_tpu_torch.index import search as search_mod
from flatnav_tpu_torch.ops import beam_hop
from flatnav_tpu_torch.ops.distances import MetricType, squared_norms
from flatnav_tpu_torch.bench._northstar import int8_operands
from flatnav_tpu_torch.ops.fused_scan import (
    _ROW_TYPES,
    VARIANTS,
    launch_as,
    scan_buckets,
    scan_buckets_plain,
    scan_operands,
    scan_variant,
)
from flatnav_tpu_torch.ops.gather_distance import (
    _VEC_TYPES,
    gather_distances,
    gather_distances_plain,
)
from flatnav_tpu_torch.ops.select_k import _plan, _route, run_rounds, select_k, select_k_plain

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_SOURCES = {"k2": ("gather_distance", "gather_distance_launch"),
            "k1": ("fused_scan", "fused_scan_launch"),
            "k3": ("select_k", "select_k_launch")}


class BaseEntry:
    """A baseline's C entry, called with its arguments by parameter name."""

    def __init__(self, lib: ctypes.CDLL, src: str, name: str):
        for m in _ENTRY.finditer(src):
            if m.group(1) == name:
                params = [p.strip() for p in m.group(2).split(",")]
                break
        else:
            raise ValueError(f'the baseline source declares no extern "C" {name}')
        self.name = name
        self.names = [re.findall(r"\w+", p)[-1] for p in params]
        self.fn = getattr(lib, name)
        self.fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        self.fn.restype = ctypes.c_int

    def __call__(self, **values) -> None:
        unknown = [n for n in self.names if n not in values]
        if unknown:
            raise ValueError(f"baseline {self.name} takes parameters this script "
                             f"does not know: {unknown}")
        _build.check(self.fn(*(values[n] for n in self.names)), f"baseline {self.name}")


def build_baseline(src_dir: Path, cases: list[str]) -> dict[str, BaseEntry]:
    """nvcc the baseline's sources for `cases` (in parallel) into
    _build/base-*.so -> {case: its C entry}."""
    _build.OUT.mkdir(exist_ok=True)
    jobs = {}
    for case in cases:
        stem, entry = _SOURCES[case]
        src = src_dir / f"{stem}.cu"
        h = hashlib.sha256(src.read_bytes() + " ".join(_build.FLAGS).encode()).hexdigest()[:16]
        out = _build.OUT / f"base-{stem}-{h}.so"
        cmd = [_build._nvcc(), *_build.FLAGS, "-o", str(out), str(src)]
        jobs[case] = (src, entry, out, None if out.exists() else subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for case, (src, entry, out, proc) in jobs.items():
        if proc is not None and proc.wait() != 0:
            raise RuntimeError(f"baseline {src.name} failed to build:\n{proc.stdout.read()}")
        entries[case] = BaseEntry(ctypes.CDLL(str(out)), src.read_text(), entry)
    return entries


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _settle(seconds: float = 1.0) -> None:
    """Keep the card busy for about `seconds` before the first timed case,
    so that its clocks have ramped up (a cold first reading otherwise)."""
    a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
    ms = timed(lambda: a @ a, reps=3, warmup=1)
    timed(lambda: a @ a, reps=max(1, int(seconds * 1e3 / ms)), warmup=0)


def alternate(fns: dict, reps: int) -> dict[str, list[float]]:
    """Time each callable twice, in the order given and then reversed."""
    out = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        out[name].append(timed(fns[name], reps, warmup=1))
    return out


def show(label: str, times: dict[str, list[float]], bound: float, by: str) -> None:
    print(f"{label}: bound {bound:.4f} ms ({by})")
    for name, ts in times.items():
        mean = sum(ts) / len(ts)
        print(f"  {name:>14}: {mean:9.4f} ms (readings {', '.join(f'{t:.4f}' for t in ts)}); "
              f"{100 * bound / mean:5.1f}% of bound")


#: K2 cases: label -> (B, C, rows, d, table type)
K2_CASES = {
    "hop": (1024, 512, 100_000, 128, torch.float32),
    "wave": (8192, 1024, 100_000, 128, torch.float32),
    "bf16-hop": (1024, 512, 100_000, 128, torch.bfloat16),
    "hop-1536": (1024, 512, 20_000, 1536, torch.float32),
    "hop-3072": (1024, 512, 20_000, 3072, torch.float32),
    "hop-4096": (1024, 512, 20_000, 4096, torch.float32),
    "hop-8192": (1024, 512, 20_000, 8192, torch.float32),
    "wave-1536": (8192, 1024, 100_000, 1536, torch.float32),
}


def _plain_in_chunks(v, ids, q, budget=1 << 31, metric=MetricType.L2):
    """`gather_distances_plain` a chunk of queries at a time, each chunk's
    padded [B, C, p] f32 block within `budget` bytes"""
    b, c = ids.shape
    p = 1 << max(0, v.shape[1] - 1).bit_length()
    step = max(1, budget // (c * p * 4))
    return torch.cat([gather_distances_plain(v, ids[lo : lo + step], q[lo : lo + step], metric)
                      for lo in range(0, b, step)])


def k2_cases(base: BaseEntry, rng, reps: int, names: list[str]) -> None:
    new = BaseEntry(_build.load("gather_distance"),
                    (_build.CSRC / "gather_distance.cu").read_text(), "gather_distance_launch")
    for name in names:
        b, c, n, d, dtype = K2_CASES[name]
        label = f"K2 {name}"
        v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().to(dtype)
        ids = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).cuda()
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).cuda()
        base_out = torch.empty((b, c), device="cuda")
        new_out = torch.empty((b, c), device="cuda")
        base_args = dict(vec=v.data_ptr(), vec_type=_VEC_TYPES[dtype], ids=ids.data_ptr(),
                         q=q.data_ptr(), n=n, d=d, B=b, C=c, ip=0, out=base_out.data_ptr(),
                         stream=_stream())
        # both through their C entries: a hop at d=128 takes about as long
        # as the wrapper's own host work, which would be timed with it
        fns = {"new": lambda: new(**{**base_args, "out": new_out.data_ptr()})}
        refused = _refuses(base, **base_args)  # a version with a width limit
        if not refused:
            fns = {"base": lambda: base(**base_args), **fns}
        times = alternate(fns, reps)
        want = _plain_in_chunks(v, ids, q)
        if not torch.equal(gather_distances(v, ids, q), new_out):
            raise RuntimeError(f"{label}: the wrapper and the entry differ")
        checked = {"new": new_out, **({} if refused else {"base": base_out})}
        for key, got in checked.items():
            if not torch.equal(got, want):
                raise RuntimeError(f"{label}: {key} differs from the plain version")
        del want, checked
        times["plain"] = [timed(lambda: _plain_in_chunks(v, ids, q), reps=1, warmup=0)]
        bound, by = gather_bound(v, ids, q)
        show(f"{label} B={b} C={c} d={d} {dtype} ({int(torch.unique(ids).numel())} distinct "
             f"rows; {'the baseline refuses this width; new' if refused else 'both'} "
             f"bit-equal)", times, bound, by)
        gathered = b * c * d * v.element_size()
        for key, ts in times.items():
            print(f"  {key:>14}: gathered bytes {gathered / 1e6:.1f} MB at "
                  f"{gathered / (sum(ts) / len(ts) * 1e-3) / 1e12:.2f} TB/s")


#: K1 cases: label -> (queries, rows, valid rows, d, row type, query type,
#: T, L, metric). The north-star shapes are the first query chunk
#: `fused_knn` gives K1 there.
K1_CASES = {
    "1M": (4096, 1_000_000, 1_000_000, 128, torch.bfloat16, torch.bfloat16, 2048, 16, "l2"),
    "path": (1024, 108_192, 100_000, 128, torch.bfloat16, torch.bfloat16, 2048, 16, "l2"),
    "gist": (4096, 1_000_000, 1_000_000, 960, torch.bfloat16, torch.bfloat16, 2048, 16, "l2"),
    "angular": (4096, 1_000_000, 1_000_000, 100, torch.bfloat16, torch.bfloat16, 2048, 16, "l2"),
    "u8-10M": (4096, 10_000_000, 10_000_000, 128, torch.uint8, torch.uint8, 32768, 256, "l2"),
    "u8-100M": (512, 100_000_000, 100_000_000, 128, torch.uint8, torch.uint8, 32768, 256, "l2"),
    "u8-10M-bf16q": (4096, 10_000_000, 10_000_000, 128, torch.uint8, torch.bfloat16, 32768, 256,
                     "l2"),
    "spacev-10M": (4096, 10_000_000, 10_000_000, 100, torch.int8, torch.int8, 32768, 256, "l2"),
    "spacev-100M": (512, 100_000_000, 100_000_000, 100, torch.int8, torch.int8, 32768, 256, "l2"),
    "spacev-10M-bf16q": (4096, 10_000_000, 10_000_000, 100, torch.int8, torch.bfloat16, 32768,
                         256, "l2"),
    "glove-25": (4096, 1_183_514, 1_183_514, 25, torch.bfloat16, torch.bfloat16, 4096, 32, "ip"),
    "glove-50": (4096, 1_183_514, 1_183_514, 50, torch.bfloat16, torch.bfloat16, 4096, 32, "ip"),
    "openai-1536": (4096, 1_000_000, 1_000_000, 1536, torch.bfloat16, torch.bfloat16, 2048, 16,
                    "ip"),
    "openai-3072": (4096, 1_000_000, 1_000_000, 3072, torch.bfloat16, torch.bfloat16, 2048, 16,
                    "ip"),
}


def _k1_inputs(qc, n, d, dtype, qdtype=None, metric="l2", seed=0):
    """Rows and queries made on the card from a seed: normal bf16 (rows and
    queries of unit norm for "ip"), or uniform uint8 / int8 (queries of
    `qdtype`, the rows' type by default, bf16 holding the same values)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype in (torch.uint8, torch.int8):
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        rows = torch.randint(lo, hi, (n, d), dtype=dtype, device="cuda", generator=g)
        q = torch.randint(lo, hi, (qc, d), dtype=dtype, device="cuda", generator=g)
        return rows, q if qdtype in (None, dtype) else q.to(qdtype)
    rows = torch.randn((n, d), device="cuda", generator=g)
    q = torch.randn((qc, d), device="cuda", generator=g)
    if metric == "ip":
        rows /= rows.norm(dim=1, keepdim=True)
        q /= q.norm(dim=1, keepdim=True)
    return rows.to(torch.bfloat16), q.to(torch.bfloat16)


def _refuses(base: BaseEntry, **args) -> bool:
    """Whether the baseline's entry refuses this launch (cudaErrorInvalidValue):
    a variant it does not have, or a shape outside that variant's rule."""
    return base.fn(*(args[n] for n in base.names)) == 1


def _base_args(variant, q, rows, pen, nlim, t, L, out_min, out_id) -> dict:
    """A baseline K1 entry's arguments by name, for a launch as `variant`."""
    return dict(q=q.data_ptr(), q_type=_ROW_TYPES[q.dtype], rows=rows.data_ptr(),
                row_type=_ROW_TYPES[rows.dtype], pen=pen.data_ptr(), qc=q.shape[0],
                n=rows.shape[0], d=rows.shape[1], nlim=nlim, t=t, L=L, nb=out_min.shape[1],
                variant=VARIANTS[variant], out_min=out_min.data_ptr(),
                out_id=out_id.data_ptr(), stream=_stream())


def k1_cases(bases: list[BaseEntry], reps: int, names: list[str], also: list[str] = ()) -> None:
    """Each case: each baseline entry on what its `fused_knn` gave it (see
    the module's docstring), this checkout's `scan_buckets` on what
    `fused_knn` gives it now (`scan_operands`), each `also` variant that
    admits these operands, the plain version once, and the library
    yardsticks: a bf16 `torch.matmul` of the same product and, for 8-bit
    rows and queries, `torch._int_mm` (row chunks of at most 2 GiB output).
    This checkout's results are held to the first baseline's (to the plain
    version's where it refuses the launch), bit-equal on 8-bit rows; the
    further baselines' are printed against the same, not held to them (a
    copy with a part taken out computes something else)."""
    for name in names:
        qc, n, nlim, d, dtype, qdtype, t, L, metric = K1_CASES[name]
        rows, q = _k1_inputs(qc, n, d, dtype, qdtype, metric)
        rows_new, q_new = scan_operands(rows, q)
        q_bf = q.to(torch.bfloat16)
        pen = (squared_norms(rows) if metric == "l2"
               else torch.zeros(n, dtype=torch.float32, device="cuda"))
        nb = -(-n // t) * (t // L)
        variant = scan_variant(q_new, rows_new, pen, t, L)
        fns, outs = {}, {}
        for i, base in enumerate(bases):
            out = (torch.empty((qc, nb), device="cuda"),
                   torch.empty((qc, nb), dtype=torch.int32, device="cuda"))
            base_variant, bq, brows = variant, q_new, rows_new
            if "q_type" not in base.names:  # an entry without 8-bit queries: bf16, unpadded rows
                base_variant = "wgmma" if variant == "wgmma" and rows_new is rows else "mma"
                bq, brows = q_bf, rows
            args = _base_args(base_variant, bq, brows, pen, nlim, t, L, *out)
            if "q_type" in base.names and _refuses(base, **args):
                # a parent without this variant: its fused_knn gave "mma" bf16 queries
                base_variant, bq = "mma", q_new.to(torch.bfloat16)
                args = _base_args(base_variant, bq, brows, pen, nlim, t, L, *out)
            label = f"base{i + 1 if i else ''} {base_variant}"
            if _refuses(base, **args):  # e.g. "mma" past its shared memory
                print(f"K1 {name}: {label.split()[0]} refuses this launch; not timed")
                continue
            fns[label] = lambda b=base, a=args: b(**a)
            outs[label] = out
        fns[f"new {variant}"] = lambda: scan_buckets(q_new, rows_new, pen, nlim, t, L)
        alt_out = {}
        for alt in also:
            if alt == variant:
                continue
            ao = (torch.empty((qc, nb), device="cuda"),
                  torch.empty((qc, nb), dtype=torch.int32, device="cuda"))
            if launch_as(alt, q_new, rows_new, pen, nlim, t, L, *ao) == 0:
                alt_out[f"as {alt}"] = ao
                fns[f"new as {alt}"] = (lambda a=alt, o=ao: _build.check(
                    launch_as(a, q_new, rows_new, pen, nlim, t, L, *o), f"K1 as {a}"))
        times = alternate(fns, reps)
        held = {"new": scan_buckets(q_new, rows_new, pen, nlim, t, L), **alt_out}
        ref = next((k for k in outs if k.startswith("base ")), None)
        want = outs.pop(ref) if ref else scan_buckets_plain(q_new, rows_new, pen, nlim, t, L)
        fin = torch.isfinite(want[0])
        for label, (got_min, got_id) in {**held, **outs}.items():
            err = float((got_min[fin] - want[0][fin]).abs().max())
            same = float((got_id == want[1]).float().mean())
            exact = torch.equal(got_min, want[0]) and torch.equal(got_id, want[1])
            print(f"  {label} against {'base' if ref else 'plain'}: max abs diff "
                  f"{err:g}, ids equal {100 * same:.3f}%{' (bit-equal)' if exact else ''}")
            if label in held and dtype != torch.bfloat16 and not exact:
                raise RuntimeError(f"K1 {name}: 8-bit keys differ from the baseline's")
        del held, outs, want, alt_out
        times["plain"] = [timed(lambda: scan_buckets_plain(q_new, rows_new, pen, nlim, t, L),
                                reps=1, warmup=0)]
        del rows_new
        times["torch.matmul bf16"] = [_chunked_matmul_ms(q_bf, rows.to(torch.bfloat16), reps)]
        if d % 8:
            dp = -(-d // 8) * 8
            pad = lambda x: torch.nn.functional.pad(x.to(torch.bfloat16), (0, dp - d))  # noqa: E731
            times[f"torch.matmul bf16 d={dp}"] = [_chunked_matmul_ms(pad(q), pad(rows), reps)]
        if dtype != torch.bfloat16 and q.dtype == dtype:
            q8, rows8 = int8_operands(q, rows)
            times["torch._int_mm"] = [_chunked_int_mm_ms(q8, rows8, reps)]
            del rows8
        bound, by = scan_bound(qc, n, d, nb, row_bytes=rows.element_size(),
                               q_bytes=q_new.element_size())
        show(f"K1 {name}: {qc} x {n} (valid {nlim}) d={d} {str(dtype)[6:]} rows, "
             f"{str(q.dtype)[6:]} queries, {metric}, T={t} L={L}", times, bound, by)
        del rows, q, q_bf, pen
        torch.cuda.empty_cache()


def _chunked_matmul_ms(q, rows, reps):
    step = max(128, (2 << 30) // (2 * q.shape[0]))

    def run():
        for lo in range(0, rows.shape[0], step):
            torch.matmul(q, rows[lo : lo + step].T)

    return timed(run, reps, warmup=1)


def _chunked_int_mm_ms(q8, rows8, reps):
    step = max(128, (2 << 30) // (4 * q8.shape[0]) // 128 * 128)

    def run():
        for lo in range(0, rows8.shape[0], step):
            torch._int_mm(q8, rows8[lo : lo + step].T)

    return timed(run, reps, warmup=1)


#: K3 cases: label -> (B, W, k, ids, keys). ids: "full" ([B, W] int32,
#: read), "row" (one [1, W] row) or "implicit" (start + column, not read);
#: keys: i.i.d. normal, or integers in [0, 64) ("ties", as 8-bit tables give).
K3_CASES = {
    "phaseB-1M": (4096, 62_592, 32, "full", "normal"),  # fused_knn at 1M x 128, T=2048, L=16
    "phaseB-100M": (512, 390_656, 32, "full", "ties"),  # uint8 100M, qc=512, T=32768, L=256
    "fast-tile": (4096, 131_072, 32, "implicit", "normal"),  # fast_knn's default tile
    "fast-tile-262k": (4096, 262_144, 32, "implicit", "normal"),  # profile_scan_bound's
    "brute-tile": (4096, 65_536, 10, "implicit", "normal"),  # brute_force_knn's tile
    "pq-tile": (4096, 32_768, 64, "implicit", "normal"),  # pq_scan_knn, rerank 64
    "pq-tile-1024": (1024, 32_768, 1024, "implicit", "normal"),  # the 100M PQ's widest
    "build": (8192, 8192, 64, "row", "normal"),  # the wave build's intra-wave block
    "merge": (4096, 64, 32, "full", "normal"),  # a scan's merge of two r-wide lists
    "routed": (16384, 196, 8, "row", "normal"),  # routed scan: rows to their 8 nearest cells
    "B1": (1, 131_072, 32, "implicit", "normal"),  # one query (the latency protocol)
}


#: K3 cases seeded with a running shortlist, as `_merge_tile` gives them:
#: label -> (B, W, k, ids, keys) as in K3_CASES; the prior is the k smallest
#: of an earlier tile of the same shape
K3_SEEDED = {
    "merge-tile": (4096, 131_072, 32, "implicit", "normal"),  # fast_knn's tile and its merge
    "brute-merge-tile": (4096, 65_536, 10, "implicit", "normal"),  # brute_force_knn's
    "pq-merge-tile": (4096, 32_768, 64, "implicit", "normal"),  # pq_scan_knn's, rerank 64
    "pq-merge-tile-1024": (1024, 32_768, 1024, "implicit", "normal"),  # the 100M PQ's widest
}


def base_select(select, keys, k, ids=None, id_base=0, cols=None):
    """A version's `select_k.cu` driven as the parent's wrapper drove it
    (the wrapper's rounds, `run_rounds`, with no prior): `select` is a
    baseline's entry or this checkout's `select_k` (which then launches as
    it always does). -> ((keys [B, k], ids [B, k]), launches)"""
    if select is select_k:
        before = select_k.launches
        return select_k(keys, k, ids=ids, id_base=id_base, cols=cols), select_k.launches - before
    routes = []

    def launch(route, args):
        select(**args)  # an entry without `route` or a prior takes what it declares
        routes.append(route)

    return run_rounds(launch, _stream(), keys, k, ids, id_base, cols), len(routes)


def base_merge_tile(select, best_d, best_i, keys, start):
    """The parent's `_merge_tile`, with `select` as in `base_select`: the
    tile's r smallest, then the r smallest of the concatenated 2r.
    -> ((keys, ids), launches)"""
    r = best_d.shape[1]
    (tile_d, tile_i), n1 = base_select(select, keys, r, id_base=start)
    out, n2 = base_select(select, torch.cat([best_d, tile_d], 1), r,
                          ids=torch.cat([best_i, tile_i], 1))
    return out, n1 + n2


def _k3_same(got, want):
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))


def k3_cases(reps: int, names: list[str], base: BaseEntry | None = None) -> list[dict]:
    out = []
    for name in names:
        seeded = name in K3_SEEDED
        b, w, k, ids_kind, keys_kind = (K3_SEEDED if seeded else K3_CASES)[name]
        g = torch.Generator(device="cuda").manual_seed(0)
        if keys_kind == "ties":
            keys = torch.randint(0, 64, (b, w), device="cuda", generator=g).float()
        else:
            keys = torch.randn((b, w), device="cuda", generator=g)
        kw = {"id_base": 1_000_000}
        if ids_kind == "full":
            kw = {"ids": torch.randint(0, 1 << 30, (b, w), device="cuda", generator=g,
                                       dtype=torch.int32)}
        elif ids_kind == "row":
            kw = {"ids": torch.arange(w, dtype=torch.int32, device="cuda")[None, :]}
        if seeded:  # the running shortlist after an earlier tile
            earlier = torch.randn((b, w), device="cuda", generator=g)
            kw["prior"] = select_k_plain(earlier, k, id_base=kw["id_base"] + w)
            del earlier
        want = select_k_plain(keys, k, **kw)
        before = select_k.launches
        got = select_k(keys, k, **kw)
        launches = select_k.launches - before
        if not _k3_same(got, want):
            raise RuntimeError(f"K3 {name}: differs from the plain version")
        fns = {"K3": lambda: select_k(keys, k, **kw)}
        if seeded:  # this kernel as the parent's _merge_tile drove its own
            two = lambda: base_merge_tile(select_k, *kw["prior"], keys, kw["id_base"])  # noqa: E731
            if not _k3_same(two()[0], want):
                raise RuntimeError(f"K3 {name}: the two-launch form differs from the plain version")
            fns["K3 two launches"] = two
        base_launches = None
        if base is not None:
            if seeded:
                call = lambda: base_merge_tile(base, *kw["prior"], keys, kw["id_base"])  # noqa: E731
            else:
                call = lambda: base_select(base, keys, k, **kw)  # noqa: E731
            got_base, base_launches = call()
            if not _k3_same(got_base, want):
                raise RuntimeError(f"K3 {name}: the baseline differs from the plain version")
            fns = {"base": call, **fns}
        fns["torch.topk"] = lambda: torch.topk(keys, k, dim=1, largest=False)
        times = alternate(fns, reps)
        times["plain"] = [timed(lambda: select_k_plain(keys, k, **kw), reps=1, warmup=1)]
        bound, by = select_bound(b, w, k, ids=ids_kind, prior=seeded)
        route = _route(k, _plan(b, w, k)[0][1])
        show(f"K3 {name}: [{b}, {w}] -> {k}, {ids_kind} ids, {keys_kind} keys"
             f"{', seeded with a prior [B, k]' if seeded else ''}, route {route}, {launches} "
             f"launch{'es' if launches > 1 else ''}"
             f"{'' if base is None else f' (base {base_launches})'} (bit-equal)",
             times, bound, by)
        mean = {x: sum(t) / len(t) for x, t in times.items()}
        out.append({"case": name, "b": b, "w": w, "k": k, "ids": ids_kind, "keys": keys_kind,
                    "prior": seeded, "route": route, "launches": launches,
                    "base_launches": base_launches, "bound_ms": bound, "bound_by": by,
                    "k3_ms": mean["K3"], "base_ms": mean.get("base"),
                    "k3_two_launches_ms": mean.get("K3 two launches"),
                    "topk_ms": mean["torch.topk"], "plain_ms": mean["plain"]})
        del keys, kw, got, want
        torch.cuda.empty_cache()
    return out


#: hop cases: label -> (B, ef, E, M): the graph cells' searches and a build wave
HOP_CASES = {"sift": (1000, 512, 64, 32), "gist": (1000, 192, 16, 32),
             "glove": (1000, 1536, 64, 32), "wave": (8192, 100, 16, 32)}
#: K2 at a graph cell's hop: label -> (rows, d, metric, the share of the
#: hop's candidates that are fresh in the cell's searches: its
#: `search.dist_comps_per_query` less the entry's 101, over the slots scored)
K2_HOP_CASES = {"sift": (1_000_000, 128, MetricType.L2, 0.32),
                "gist": (1_000_000, 960, MetricType.L2, 0.35),
                "glove": (1_183_514, 100, MetricType.IP, 0.28)}


def _hop_state(b, ef, e_f, m, g, n=1_000_000, again=1 / 3, in_row=True):
    """A mid-search hop's inputs over n ids: hop `it`, a third of the cap;
    an ordered beam, about half of it expanded; it*E ids in the history;
    candidates of which a share `again` repeat the beam, the history or
    (`in_row`) the row. A repeat of the row can copy a candidate that was
    itself replaced, and so be fresh; without `in_row` the share of fresh
    candidates is close to 1 - again."""
    em = e_f * m
    hop_cap = search_mod._hop_cap(ef, e_f)
    it = hop_cap // 3

    def ids(shape):
        return torch.randint(0, n, shape, device="cuda", generator=g, dtype=torch.int32)

    beam_d = torch.rand((b, ef), device="cuda", generator=g).sort(dim=1).values
    beam_i = ids((b, ef))
    beam_e = torch.rand((b, ef), device="cuda", generator=g) < 0.5
    visited = torch.full((b, hop_cap * e_f), -1, dtype=torch.int32, device="cuda")
    visited[:, : it * e_f] = ids((b, it * e_f))
    nbrs = ids((b, em))
    seen = torch.cat([beam_i, visited[:, : it * e_f], *([nbrs] if in_row else [])], dim=1)
    pick = torch.randint(0, seen.shape[1], (b, em), device="cuda", generator=g)
    again = torch.rand((b, em), device="cuda", generator=g) < again
    nbrs = torch.where(again, seen.gather(1, pick), nbrs)
    scores = torch.rand((b, em), device="cuda", generator=g)
    return it, (beam_d, beam_i, beam_e, visited), nbrs, scores


def hop_lockstep(links, score, entry, n: int, b: int, *, ef: int, e_f: int, cw: int = 0,
                 hop_cap: int = 0):
    """The hop's two engines, `ops.beam_hop.BeamHop` (the kernels) and
    `ChainHop` (the PyTorch chain), stepped side by side through the same
    methods on the same card inputs, every hop of a search from its entry
    state (`index.search.entry_beam` over 8 candidates; `hop_cap` 0: the
    search's default): after each stage the selection, the candidates, fresh
    flags and score ids, and the whole state (beam distances by their bits,
    ids, expanded marks, history, both counters) must be equal, and so must
    the end test; a difference raises. The kernels' engine scores its score
    ids, the chain every candidate, as the search did before it handed the
    scorer score ids. -> (hops run, the kernels' BeamHop)."""
    m = links.shape[1]
    hop_cap = hop_cap or search_mod._hop_cap(ef, e_f)
    start = search_mod.entry_beam(entry, n, b, ef, hop_cap * e_f, 8, links.device)
    chain = beam_hop.ChainHop(*(t.clone() for t in start), e_f=e_f, m=m, compact_width=cw)
    hop = beam_hop.BeamHop(*start, e_f=e_f, m=m, compact_width=cw)

    def same(what, *pairs):
        pairs += tuple((getattr(hop, a), getattr(chain, a)) for a in
                       ("beam_i", "beam_e", "hist", "dcomp", "hops"))
        pairs += ((hop.beam_d.view(torch.int32), chain.beam_d.view(torch.int32)),)
        if not all(torch.equal(x, y) for x, y in pairs):
            raise RuntimeError(f"hop {it}: the kernels' {what} differs from the chain's")

    for it in range(hop_cap):
        sel_c, sel_k = chain.select(), hop.select()
        same("select", *zip(sel_k, sel_c))
        nbrs = links[sel_c[0].reshape(-1).long()].reshape(b, e_f * m)
        nb_c, fr_c = chain.membership(nbrs)
        nb_k, fr_k = hop.membership(nbrs)
        same("membership", (nb_k, nb_c), (fr_k, fr_c), (hop.score_ids, chain.score_ids))
        chain.merge(score(nb_c), nb_c)
        hop.merge(score(hop.score_ids), nb_k)
        same("merge")
        left = chain.unexpanded_after(it + 1)
        if hop.unexpanded_after(it + 1) != left or int(hop.flag) != int(chain.flag):
            raise RuntimeError(f"hop {it}: the kernels' end flag differs from the chain's")
        if not left:
            break
    return it + 1, hop


def hop_cases(reps: int, names: list[str]) -> list[dict]:
    """The hop's bookkeeping by its kernels (`ops.beam_hop.BeamHop`, three
    launches) and by the PyTorch chain they replace (`ChainHop`: its stages
    and counters, without the end test), on one mid-search hop's inputs
    (`_hop_state`); the kernels held bit-equal to the chain first. Both
    engines update their state in place, so each call of a whole hop, a
    select or a merge first restores it (copies timed alone as "restore" and
    taken off their readings)."""
    out = []
    for name in names:
        b, ef, e_f, m = HOP_CASES[name]
        g = torch.Generator(device="cuda").manual_seed(0)
        it, (beam_d, beam_i, beam_e, visited), nbrs, scores = _hop_state(b, ef, e_f, m, g)
        start = (beam_d, beam_i, beam_e, visited.sort(dim=1).values)
        engines = []
        for engine in (beam_hop.BeamHop, beam_hop.ChainHop):
            counts = [torch.zeros((), dtype=torch.int64, device="cuda") for _ in range(2)]
            engines.append(engine(*(t.clone() for t in start), *counts, e_f=e_f, m=m))
        hop, chain = engines

        def restore(engine=hop):
            for s, w in zip(start, (engine.beam_d, engine.beam_i, engine.beam_e, engine.hist)):
                w.copy_(s)

        def step(engine):
            restore(engine)
            engine.select()
            nb, _ = engine.membership(nbrs)
            engine.merge(scores, nb)

        for engine in engines:
            step(engine)
        if not (torch.equal(hop.beam_d.view(torch.int32), chain.beam_d.view(torch.int32))
                and all(torch.equal(getattr(hop, a), getattr(chain, a))
                        for a in ("beam_i", "beam_e", "hist"))):
            raise RuntimeError(f"hop {name}: the kernels differ from the chain")
        fns = {
            "chain": lambda: step(chain),
            "kernels": lambda: step(hop),
            "restore": restore,
            "select": lambda: (restore(), hop.select()),
            "membership": lambda: hop.membership(nbrs),
            "merge": lambda: (restore(), hop.merge(scores, nbrs)),
        }
        times = alternate(fns, reps)
        base = sum(times["restore"]) / len(times["restore"])
        for key in ("chain", "kernels", "select", "merge"):
            times[key] = [t - base for t in times[key]]
        bound, by = hop_bound(b, ef, e_f, m, visited.shape[1])
        stage_bounds = hop_stage_bounds(b, ef, e_f, m, visited.shape[1])
        show(f"hop {name}: B={b}, ef={ef}, E={e_f}, M={m}, history {visited.shape[1]}, "
             f"hop {it} (bit-equal; chain, kernels, select and merge net of restore)",
             {k: times[k] for k in ("chain", "kernels")}, bound, by)
        print(f"  restore (a copy of the state, taken off): {base:.4f} ms")
        for stage, (stage_bound, stage_by) in stage_bounds.items():
            show(f"  {stage} against its own bound", {stage: times[stage]}, stage_bound, stage_by)
        mean = {k: sum(t) / len(t) for k, t in times.items()}
        out.append({"case": name, "b": b, "ef": ef, "e": e_f, "m": m,
                    "hist": visited.shape[1], "bound_ms": bound, "bound_by": by,
                    **{f"{k}_bound_ms": v for k, (v, _) in stage_bounds.items()},
                    **{f"{k}_ms": v for k, v in mean.items()}})
        torch.cuda.empty_cache()
    return out


def _issued(prepare, issue, reps: int) -> tuple[list[float], list[float]]:
    """(host ms to issue, card ms to run it) of `issue()` in `reps` readings,
    each after `prepare()` has run and the card is idle. A spin kernel holds
    the card while the host issues, so the card's reading is the work alone,
    back to back."""
    host, card_ms = [], []
    for _ in range(reps + 1):  # the first, a warm-up, is dropped
        prepare()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # ~2 ms at the H100's clocks
        e0.record()
        t0 = time.perf_counter()
        issue()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        e1.synchronize()
        card_ms.append(e0.elapsed_time(e1))
    return host[1:], card_ms[1:]


def hop_graph_cases(reps: int, names: list[str]) -> list[dict]:
    """A hop issued launch by launch against one replay of the captured hop
    (module docstring), on `_hop_state`'s mid-search hop over a random links
    table of 1,000,000 rows: bit-equal first (the eager hop against the
    graphs' head and tail), then `reps` readings of each."""
    out = []
    for name in names:
        b, ef, e_f, m = HOP_CASES[name]
        g = torch.Generator(device="cuda").manual_seed(2)
        _, (beam_d, beam_i, beam_e, visited), _, scores = _hop_state(b, ef, e_f, m, g)
        links = torch.randint(0, 1_000_000, (1_000_000, m), device="cuda", generator=g,
                              dtype=torch.int32)
        start = (beam_d, beam_i, beam_e, visited.sort(dim=1).values)
        counts = [torch.zeros((), dtype=torch.int64, device="cuda") for _ in range(2)]
        eager = beam_hop.BeamHop(*(t.clone() for t in start), *counts, e_f=e_f, m=m)
        nbr_rows = torch.empty((b * e_f, m), dtype=torch.int32, device="cuda")
        graphs = search_mod._HopGraphs(None, links, b, ef, e_f, visited.shape[1], 0)
        graphs.scores.copy_(scores)

        def restore(state):
            for s, w in zip(start, state):
                w.copy_(s)

        def eager_hop():
            cur, _ = eager.select()
            nb = torch.index_select(links, 0, cur.view(-1), out=nbr_rows).view(b, -1)
            cand, _ = eager.membership(nb)
            eager.merge(scores, cand)

        def graph_start():
            restore(graphs.state)
            graphs.hop.restart()
            graphs.head()

        eager_state = (eager.beam_d, eager.beam_i, eager.beam_e, eager.hist)
        eager_hop()
        graph_start()
        graphs.step(last=True)
        got = graphs.state
        if not (torch.equal(eager.beam_d.view(torch.int32), got[0].view(torch.int32))
                and all(torch.equal(x, y) for x, y in zip(eager_state[1:], got[1:4]))):
            raise RuntimeError(f"hop {name}: the replayed hop differs from the eager one")
        times = {}
        for turn in range(2):  # eager, graph; then graph, eager
            for kind in ("eager", "graph")[::1 - 2 * turn]:
                if kind == "eager":
                    h, c = _issued(lambda: restore(eager_state), eager_hop, reps)
                else:
                    h, c = _issued(graph_start, lambda: graphs.step(last=False), reps)
                times.setdefault(kind, ([], []))
                times[kind][0].extend(h)
                times[kind][1].extend(c)
        end_host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager.unexpanded_after(1)
            end_host.append((time.perf_counter() - t0) * 1e3)
        mean = {k: (sum(h) / len(h), sum(c) / len(c)) for k, (h, c) in times.items()}
        print(f"hop {name} issued: B={b}, ef={ef}, E={e_f}, M={m} (the replay bit-equal to the "
              f"eager hop); host ms to issue / card ms to run")
        for kind, (h, c) in mean.items():
            print(f"  {kind:>6}: host {h:.4f} ms, card {c:.4f} ms (host readings "
                  f"{', '.join(f'{t:.4f}' for t in times[kind][0])})")
        end = sum(end_host) / len(end_host)
        print(f"  eager end test (the flag's read, card idle): host {end:.4f} ms")
        out.append({"case": name, "b": b, "ef": ef, "e": e_f, "m": m,
                    "eager_host_ms": mean["eager"][0], "eager_card_ms": mean["eager"][1],
                    "graph_host_ms": mean["graph"][0], "graph_card_ms": mean["graph"][1],
                    "eager_end_test_host_ms": end})
        del links, graphs, eager, nbr_rows
        torch.cuda.empty_cache()
    return out


#: sequences of requests for `hop_policy_cases`: label -> (requests, query
#: counts: a list or (low, high) drawn per request, the guard's sub-batch)
HOP_POLICY_CASES = {"mixed": (96, (1, 16), 0), "split": (12, [1000], 300),
                    "fixed": (12, [1000], 0)}


def hop_policy_cases(reps: int) -> list[dict]:
    """Each `HOP_POLICY_CASES` sequence of searches (`batched_search`, k 10,
    ef 512, E 64 over a 100,000 x 128 clustered index, M 32) as the search
    runs it against the eager loop alone (`index.search._hop_graphs` giving
    None), in turns policy, eager, eager, policy, `reps` // 5 + 1 times,
    each turn from no kept hop; wall ms a request with the card synchronised
    after each (a request's answers are read on the host), apart for each
    turn's first request and the rest, and the graphs the policy captured
    (three a shape)."""
    import flatnav_tpu_torch
    from flatnav_tpu_torch.bench.synth import clustered

    n, d = 100_000, 128
    data, q = clustered(n, d, 1000, seed=11, centers_per_64k=26)
    ix = flatnav_tpu_torch.index.create("l2", d, n, 32)
    ix.add(data, ef_construction=100)
    g = ix.graph
    queries = torch.from_numpy(q).cuda()
    rng = np.random.default_rng(3)
    real_graphs, real_guard, real_capture = (search_mod._hop_graphs, search_mod.safe_query_batch,
                                             search_mod._capture)
    captured = [0]

    def counting(*args):
        captured[0] += 1
        return real_capture(*args)

    out = []
    try:
        search_mod._capture = counting
        for name, (requests, sizes, sub) in HOP_POLICY_CASES.items():
            counts = (rng.integers(sizes[0], sizes[1] + 1, requests) if isinstance(sizes, tuple)
                      else np.resize(sizes, requests))
            search_mod.safe_query_batch = ((lambda b, *a, sub=sub, **k: min(b, sub)) if sub
                                           else real_guard)
            times, firsts, shapes = {"policy": [], "eager": []}, {"policy": [], "eager": []}, []
            for turn in range(reps // 5 + 1):
                for kind in ("policy", "eager")[::1 - 2 * (turn % 2)]:
                    search_mod.release_hop_graphs()
                    search_mod._LAST_KEY.clear()
                    search_mod._hop_graphs = real_graphs if kind == "policy" else (
                        lambda *a, **k: None)
                    captured[0] = 0
                    for i, c in enumerate(counts):
                        lo = (i * 37) % (len(q) - int(c) + 1)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        search_mod.batched_search(g.vectors, g.links, g.labels, g.num_nodes,
                                                  queries[lo: lo + int(c)], k=10, ef=512,
                                                  expand_factor=64)
                        torch.cuda.synchronize()
                        (times if i else firsts)[kind].append((time.perf_counter() - t0) * 1e3)
                    if kind == "policy":
                        shapes.append(captured[0] // 3)
            every = {k: firsts[k] + times[k] for k in times}
            mean = {k: sum(t) / len(t) for k, t in every.items()}
            med = {k: float(np.median(t)) for k, t in every.items()}
            rest = {k: sum(t) / len(t) for k, t in times.items()}
            print(f"hop policy {name}: {requests} requests of {sizes} queries"
                  f"{f', split at {sub}' if sub else ''}: ms a request, mean / median: "
                  f"policy {mean['policy']:.3f} / {med['policy']:.3f}, eager "
                  f"{mean['eager']:.3f} / {med['eager']:.3f}; a turn's first request: policy "
                  f"{', '.join(f'{t:.2f}' for t in firsts['policy'])}, eager "
                  f"{', '.join(f'{t:.2f}' for t in firsts['eager'])}; the rest, mean: policy "
                  f"{rest['policy']:.3f}, eager {rest['eager']:.3f}; shapes captured a turn "
                  f"{shapes}")
            out.append({"case": name, "requests": requests, "sub_batch": sub,
                        "policy_ms": mean["policy"], "eager_ms": mean["eager"],
                        "policy_median_ms": med["policy"], "eager_median_ms": med["eager"],
                        "policy_first_ms": firsts["policy"], "eager_first_ms": firsts["eager"],
                        "policy_rest_ms": rest["policy"], "eager_rest_ms": rest["eager"],
                        "shapes_captured": shapes})
    finally:
        search_mod._hop_graphs, search_mod.safe_query_batch = real_graphs, real_guard
        search_mod._capture = real_capture
        search_mod.release_hop_graphs()
    del ix, g, queries
    torch.cuda.empty_cache()
    return out


def k2_hop_cases(reps: int, names: list[str], base: BaseEntry | None = None) -> list[dict]:
    """K2 at a graph cell's hop (`K2_HOP_CASES`): the hop's candidates from
    `_hop_state` at the cell's share of fresh ones, run through select and
    membership, then scored twice, on the candidates' own ids ("full ids",
    as the search scored them before it handed K2 score ids) and on the
    score ids (-1 where not fresh), over a table of the cell's rows and d
    (normal rows; unit rows under IP). Both through the C entry, with
    `base` (the other version's K2) on both as well. Held first: the full
    ids bit-equal to the plain version, the score ids' live slots bit-equal
    to the same, NaN elsewhere. Each reading beside `measure.gather_bound`
    of its ids (the distinct rows they name) and its time a loaded row: the
    score ids' over the full ids' is what packing the live ids buys."""
    new = BaseEntry(_build.load("gather_distance"),
                    (_build.CSRC / "gather_distance.cu").read_text(), "gather_distance_launch")
    out = []
    for name in names:
        n, d, metric, share = K2_HOP_CASES[name]
        b, ef, e_f, m = HOP_CASES[name]
        g = torch.Generator(device="cuda").manual_seed(1)
        _, start, nbrs, _ = _hop_state(b, ef, e_f, m, g, n=n, again=1 - share, in_row=False)
        beam_d, beam_i, beam_e, visited = (t.clone() for t in start)
        counts = [torch.zeros((), dtype=torch.int64, device="cuda") for _ in range(2)]
        hop = beam_hop.BeamHop(beam_d, beam_i, beam_e, visited.sort(dim=1).values, *counts,
                               e_f=e_f, m=m)
        hop.select()
        hop.membership(nbrs)
        ids = {"full ids": nbrs.contiguous(), "score ids": hop.score_ids.clone()}
        live = ids["score ids"] >= 0
        del hop, beam_d, beam_i, beam_e, visited, start
        v = torch.randn((n, d), device="cuda", generator=g)
        q = torch.randn((b, d), device="cuda", generator=g)
        if metric == MetricType.IP:
            v /= torch.linalg.vector_norm(v, dim=1, keepdim=True)
            q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
        c = nbrs.shape[1]
        outs, fns = {}, {}
        entries = {"": new, **({"base ": base} if base is not None else {})}
        for prefix, entry in entries.items():
            for kind, t in ids.items():
                key = prefix + kind
                outs[key] = torch.empty((b, c), device="cuda")
                args = dict(vec=v.data_ptr(), vec_type=_VEC_TYPES[v.dtype], ids=t.data_ptr(),
                            q=q.data_ptr(), n=n, d=d, B=b, C=c,
                            ip=int(metric == MetricType.IP), out=outs[key].data_ptr(),
                            stream=_stream())
                fns[key] = (lambda e, a: lambda: e(**a))(entry, args)
        times = alternate(fns, reps)
        want = _plain_in_chunks(v, ids["full ids"], q, metric=metric)
        for key, got in outs.items():
            ok = (torch.equal(got, want) if key.endswith("full ids") else
                  torch.equal(got[live], want[live]) and bool(got[~live].isnan().all()))
            if not ok:
                raise RuntimeError(f"K2 at the {name} hop: {key} differs from the plain version")
        del want
        loaded = {"full ids": b * c, "score ids": int(live.sum())}
        bounds = {kind: gather_bound(v, t, q) for kind, t in ids.items()}
        distinct = {kind: int(torch.unique(t[t >= 0]).numel()) for kind, t in ids.items()}
        print(f"K2 at the {name} hop: B={b} C={c} d={d} {metric.name} over {n:,} rows; "
              f"{loaded['score ids']:,} of {b * c:,} slots fresh "
              f"({100 * loaded['score ids'] / (b * c):.1f}%); distinct rows "
              f"{distinct['full ids']:,} (full ids), {distinct['score ids']:,} (score ids); "
              f"bit-equal")
        mean = {k: sum(ts) / len(ts) for k, ts in times.items()}
        row = {"case": name, "b": b, "c": c, "d": d, "n": n, "metric": metric.name,
               "slots": b * c, "live": loaded["score ids"],
               "distinct_full": distinct["full ids"], "distinct_live": distinct["score ids"]}
        for key, ts in times.items():
            kind = "full ids" if key.endswith("full ids") else "score ids"
            bound = bounds[kind][0]
            per_row = mean[key] * 1e6 / loaded[kind]
            print(f"  {key:>16}: {mean[key]:8.4f} ms (readings "
                  f"{', '.join(f'{t:.4f}' for t in ts)}); {per_row:.3f} ns a loaded row; "
                  f"{100 * bound / mean[key]:5.1f}% of its bound {bound:.4f} ms")
            row[key.replace(" ", "_") + "_ms"] = mean[key]
            row[kind.replace(" ", "_") + "_bound_ms"] = bound
        for prefix in entries:
            ratio = ((mean[prefix + "score ids"] / loaded["score ids"])
                     / (mean[prefix + "full ids"] / loaded["full ids"]))
            print(f"  {(prefix or 'new ') + 'K2'}: a loaded row takes {ratio:.3f}x as long on "
                  f"the score ids as on the full ids")
            row[prefix.replace(" ", "_") + "row_time_ratio"] = ratio
        out.append(row)
        del v, q, ids, outs, fns, live
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, nargs="+",
                    help="the other version's csrc (needed by k1 and k2; k3 and hop "
                         "optional), then K1 copies timed beside it")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default="k2,k1", help="comma-separated: k2, k1, k3, hop")
    ap.add_argument("--k1", default=",".join(K1_CASES),
                    help=f"comma-separated K1 cases: {', '.join(K1_CASES)}")
    ap.add_argument("--k2", default=",".join(K2_CASES),
                    help=f"comma-separated K2 cases: {', '.join(K2_CASES)}")
    ap.add_argument("--also", default="",
                    help=f"comma-separated K1 variants also timed where they admit a case's "
                         f"operands: {', '.join(VARIANTS)}")
    ap.add_argument("--k3", default=",".join([*K3_CASES, *K3_SEEDED]),
                    help=f"comma-separated K3 cases: {', '.join([*K3_CASES, *K3_SEEDED])}")
    ap.add_argument("--hop", default=",".join(HOP_CASES),
                    help=f"comma-separated hop cases: {', '.join(HOP_CASES)}")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    ab = [c for c in cases if c not in ("k3", "hop")]
    if ab and args.baseline is None:
        ap.error(f"--cases {','.join(ab)} needs --baseline")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    _build.build(sorted({s for c in cases for s in (
        [_SOURCES[c][0]] if c in _SOURCES else ["beam_hop", "gather_distance"])}))
    with_base = list(ab)  # k3 and the hop's K2 take a baseline where one is given
    if args.baseline is not None:
        with_base += [c for c, asked in (("k3", "k3" in cases), ("k2", "hop" in cases))
                      if asked and c not in with_base]
    base = build_baseline(args.baseline[0], with_base) if with_base else {}
    copies = [build_baseline(d, ["k1"])["k1"] for d in args.baseline[1:]] if "k1" in cases else []
    labels = [f"base{i + 1 if i else ''} {d}" for i, d in enumerate(args.baseline or [])]
    print(f"{card()}; torch {torch.__version__}; baseline {', '.join(labels) or None}")
    _settle()
    rng = np.random.default_rng(0)
    if "k2" in cases:
        k2_cases(base["k2"], rng, args.reps, args.k2.split(","))
    if "k1" in cases:
        k1_cases([base["k1"], *copies], args.reps, args.k1.split(","),
                 [v for v in args.also.split(",") if v])
    if "k3" in cases:
        print(json.dumps({"card": card(), "baseline": None if "k3" not in base else
                          str(args.baseline[0]),
                          "k3": k3_cases(args.reps, args.k3.split(","), base.get("k3"))}))
    if "hop" in cases:
        hops = args.hop.split(",")
        print(json.dumps({"card": card(), "hop": hop_cases(args.reps, hops)}))
        print(json.dumps({"card": card(), "hop_graph": hop_graph_cases(args.reps, hops)}))
        print(json.dumps({"card": card(), "hop_policy": hop_policy_cases(args.reps)}))
        print(json.dumps({"card": card(), "k2_at_hop": k2_hop_cases(
            args.reps, [h for h in hops if h in K2_HOP_CASES], base.get("k2"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
