"""scan.prepare_ms: device milliseconds a request of the operations launched
inside the program's `flatnav.scan.prepare` ranges (`fused_knn`'s bf16
operands and norms of the table, made every call; ops/fused_scan.py), over
the profiled requests of the program phase (torch.profiler;
annbench/program.py)."""

from annbench import program

SPANS = program.SPANS


def read(ctx):
    found = program.profiled(ctx)
    if not found.get("ranges.scan.prepare") or not found.get("requests"):
        return None
    return found.get("ms.scan.prepare", 0.0) / found["requests"]
