"""Kernels of this checkout against another version's, alternating on the card.

    python -m flatnav_tpu_torch.bench.kernel_ab --baseline DIR [--reps 10] [--cases k2,k1]

DIR holds the other version's `gather_distance.cu` and/or `fused_scan.cu`,
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
two readings of one kernel.

Cases, at the main path's shapes and the 1M scan's:
  K2 hop       B=1024, C=512, d=128 float32 over 100,000 rows (random ids)
  K2 wave      B=8192, C=1024, d=128 float32 (a build wave)
  K2 bf16 hop  the hop on a bfloat16 table
  K2 d=4096    B=1024, C=512, d=4096 float32 over 20,000 rows
  K1 1M        4096 queries x 1,000,000 rows, d=128 bf16, T=2048, L=16
  K1 path      1024 queries x 108,192 rows (100,000 valid), T=2048, L=16
Each line gives the bound (`measure.gather_bound` / `measure.scan_bound`)
and, for K1, the time of torch.matmul bf16 on the same inputs. Needs a CUDA
card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.bench.measure import card, gather_bound, scan_bound, timed
from flatnav_tpu_torch.ops.distances import squared_norms
from flatnav_tpu_torch.ops.fused_scan import VARIANTS, scan_buckets, scan_variant
from flatnav_tpu_torch.ops.gather_distance import (
    _VEC_TYPES,
    gather_distances,
    gather_distances_plain,
)

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_SOURCES = {"k2": ("gather_distance", "gather_distance_launch"),
            "k1": ("fused_scan", "fused_scan_launch")}


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


def k2_cases(base: BaseEntry, rng, reps: int) -> None:
    for label, b, c, n, d, dtype in (("K2 hop", 1024, 512, 100_000, 128, torch.float32),
                                     ("K2 wave", 8192, 1024, 100_000, 128, torch.float32),
                                     ("K2 bf16 hop", 1024, 512, 100_000, 128, torch.bfloat16),
                                     ("K2 d=4096", 1024, 512, 20_000, 4096, torch.float32)):
        v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().to(dtype)
        ids = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).cuda()
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).cuda()
        base_out = torch.empty((b, c), device="cuda")
        fns = {
            "base": lambda: base(vec=v.data_ptr(), vec_type=_VEC_TYPES[dtype], ids=ids.data_ptr(),
                                 q=q.data_ptr(), n=n, d=d, B=b, C=c, ip=0,
                                 out=base_out.data_ptr(), stream=_stream()),
            "new": lambda: gather_distances(v, ids, q),
        }
        times = alternate(fns, reps)
        want = gather_distances_plain(v, ids, q)
        for key, got in (("base", base_out), ("new", gather_distances(v, ids, q))):
            if not torch.equal(got, want):
                raise RuntimeError(f"{label}: {key} differs from the plain version")
        bound, by = gather_bound(v, ids, q)
        show(f"{label} B={b} C={c} d={d} {dtype} ({int(torch.unique(ids).numel())} distinct "
             f"rows; both bit-equal)", times, bound, by)
        gathered = b * c * d * v.element_size()
        for key, ts in times.items():
            print(f"  {key:>14}: gathered bytes {gathered / 1e6:.1f} MB at "
                  f"{gathered / (sum(ts) / len(ts) * 1e-3) / 1e12:.2f} TB/s")


def k1_cases(base: BaseEntry, rng, reps: int) -> None:
    d, t, L = 128, 2048, 16
    for label, qc, n, nlim in (("K1 1M", 4096, 1_000_000, 1_000_000),
                               ("K1 path", 1024, 108_192, 100_000)):
        rows = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda().to(torch.bfloat16)
        q = torch.from_numpy(rng.standard_normal((qc, d), dtype=np.float32)).cuda().to(torch.bfloat16)
        pen = squared_norms(rows)
        nb = -(-n // t) * (t // L)
        variant = scan_variant(q, rows, pen, t, L)
        om = torch.empty((qc, nb), device="cuda")
        oi = torch.empty((qc, nb), dtype=torch.int32, device="cuda")
        fns = {
            "base": lambda: base(q=q.data_ptr(), rows=rows.data_ptr(), row_type=0,
                                 pen=pen.data_ptr(), qc=qc, n=n, d=d, nlim=nlim, t=t, L=L,
                                 nb=nb, variant=VARIANTS[variant], out_min=om.data_ptr(),
                                 out_id=oi.data_ptr(), stream=_stream()),
            f"new {variant}": lambda: scan_buckets(q, rows, pen, nlim, t, L),
            "torch.matmul": lambda: torch.matmul(q, rows.T),
        }
        times = alternate(fns, reps)
        new_min, new_id = scan_buckets(q, rows, pen, nlim, t, L)
        fin = torch.isfinite(om)
        err = float((new_min[fin] - om[fin]).abs().max())
        same = float((new_id == oi).float().mean())
        print(f"  new {variant} against base: max abs diff {err:g}, ids equal {100 * same:.3f}%")
        bound, by = scan_bound(qc, n, d, nb)
        waves = (-(-qc // 128) * -(-n // t) * (t // L // 128)
                 / torch.cuda.get_device_properties(0).multi_processor_count)
        show(f"{label} {qc} x {n} (valid {nlim}) d={d} T={t} L={L}; wgmma grid = {waves:.2f} "
             f"waves of one block per SM", times, bound, by)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default="k2,k1", help="comma-separated: k2, k1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    cases = args.cases.split(",")
    _build.build([_SOURCES[c][0] for c in cases])
    base = build_baseline(args.baseline, cases)
    print(f"{card()}; torch {torch.__version__}; baseline {args.baseline}")
    rng = np.random.default_rng(0)
    if "k2" in cases:
        k2_cases(base["k2"], rng, args.reps)
    if "k1" in cases:
        k1_cases(base["k1"], rng, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
