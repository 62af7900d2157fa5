"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` on
its own into `_build/<name>-<hash>.so` (git-ignored), where the hash covers
the source and the flags, so an edited source rebuilds and an unchanged one
is reused. The library is loaded with ctypes. Nothing is built or loaded
when a module is imported: the first launch of a kernel builds it, and
`build()` builds several at once (one nvcc process per source, all started
together).

Run `python -m flatnav_tpu_torch._build` to build every kernel and print
the compiler's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
OUT = Path(__file__).parent / "_build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_libs: dict[str, ctypes.CDLL] = {}
#: name -> (seconds, ptxas report) of the builds this process ran
reports: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return OUT / f"{name}-{h}.so"


def build(names: list[str] | None = None) -> dict[str, tuple[float, str]]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel. Raises with the compiler's output if any build fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    OUT.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    done = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target(name))  # atomic: readers never see a partial .so
        done[name] = (time.perf_counter() - t0, out)
    reports.update(done)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(target(name)))
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


if __name__ == "__main__":
    for n, (sec, report) in build().items():
        print(f"{n}: built in {sec:.1f} s\n{report}")
