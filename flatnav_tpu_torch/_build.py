"""Build and load the port's native libraries.

Each `csrc/<name>.cu` (a CUDA kernel) and `csrc/<name>.cpp` (host code) has
a plain C interface and is compiled on its own into
`_build/<name>-<hash>.so` (git-ignored), where the hash covers the source
and the flags, so an edited source rebuilds and an unchanged one is reused.
`nvcc` compiles a `.cu`; the host compiler (`g++`, or `nvcc -x c++` where
only nvcc is on the path) compiles a `.cpp`. The library is loaded with
ctypes. Nothing is built or loaded when a module is imported: the first use
of a library builds it, and `build()` builds several at once (one compiler
process per source, all started together).

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
HOST_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared"]

_libs: dict[str, ctypes.CDLL] = {}
#: name -> (seconds, ptxas report) of the builds this process ran
reports: dict[str, tuple[float, str]] = {}


def _find_nvcc() -> str | None:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def host_compiler() -> list[str] | None:
    """The command that compiles a `.cpp` source: `g++`, else `nvcc -x c++`
    (which drives the host compiler it finds); None where the machine has no
    compiler at all."""
    gxx = shutil.which("g++")
    if gxx:
        return [gxx, *HOST_FLAGS]
    nvcc = _find_nvcc()
    if nvcc:
        return [nvcc, "-x", "c++", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    return None


def sources() -> list[str]:
    """The CUDA kernels (the host library of csrc/*.cpp is not one)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source(name: str) -> tuple[Path, list[str]]:
    """-> (source file, the flags its hash covers)"""
    cu = CSRC / f"{name}.cu"
    return (cu, FLAGS) if cu.exists() else (CSRC / f"{name}.cpp", HOST_FLAGS)


def target(name: str) -> Path:
    src, flags = _source(name)
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return OUT / f"{name}-{h}.so"


def _command(name: str) -> list[str]:
    src, _ = _source(name)
    if src.suffix == ".cu":
        return [_nvcc(), *FLAGS]
    cmd = host_compiler()
    if cmd is None:
        raise RuntimeError(f"no C++ compiler found: {src.name} cannot be built")
    return cmd


def build(names: list[str] | None = None) -> dict[str, tuple[float, str]]:
    """Compile the named libraries (default: every CUDA kernel) that are not
    built yet, in parallel. Raises with the compiler's output if any build
    fails."""
    names = sources() if names is None else names
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    OUT.mkdir(exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [*_command(name), "-o", str(tmp), str(_source(name)[0])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), os.path.basename(cmd[0]))
    failed = []
    done = {}
    for name, (tmp, proc, compiler) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} ({compiler} exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target(name))  # atomic: readers never see a partial .so
        done[name] = (time.perf_counter() - t0, out)
    reports.update(done)
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name`, built on first use."""
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
