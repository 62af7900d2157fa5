"""Start one process ("rank") a device, joined by `torch.distributed`.

The counterpart of the single-controller JAX runtime that
flatnav_tpu/parallel runs under: `run_ranks(fn, world, ...)` spawns `world`
ranks, initialises the process group in each (the backend is the caller's,
never switched), calls `fn(*args)` in every rank and returns rank 0's
result. `fn` must be importable by its module path (the ranks start from a
fresh interpreter), and what it returns is pickled back.

The ranks meet at a `file://` rendezvous in a fresh temporary directory, so
concurrent groups (test workers, say) never share a port. A collective the
ranks disagree on hangs rather than failing, so the call has a deadline:
past `timeout` seconds every rank is killed and `run_ranks` raises
TimeoutError. A rank that raises makes `run_ranks` raise RuntimeError with
its traceback.

Devices: with device "cuda" rank r takes card r % device_count, so on one
card every rank shares card 0. Only gloo allows that; NCCL needs a card a
rank. With device "cpu" each rank gets an equal share of the host's cores.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, backend, device, timeout, rendezvous, results, fn, args):
    try:
        # the ranks meet on this host only: gloo and NCCL bootstrap over loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, init_method=rendezvous, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *, backend: str, device: str, timeout: float, args=()):
    """Run `fn(*args)` in `world` ranks over `backend` ("gloo" or "nccl") on
    `device` ("cpu" or "cuda"); returns rank 0's result."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda'): no CUDA device is available")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="flatnav_ranks_")
    rendezvous = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(
                target=_rank_main,
                args=(rank, world, backend, device, timeout, rendezvous, results, fn, args),
                daemon=True,
            )
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        done, out = set(), None
        while len(done) < world:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: {world - len(done)} of {world} ranks still running "
                        f"after {timeout} s (a collective the ranks disagree on hangs)"
                    ) from None
                dead = [p.exitcode for i, p in enumerate(procs) if i not in done and p.exitcode]
                if dead:
                    raise RuntimeError(f"run_ranks: a rank exited with code {dead[0]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} raised:\n{payload}")
            done.add(rank)
            if rank == 0:
                out = payload
        for p in procs:
            p.join(timeout=30)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


__all__ = ["run_ranks"]
