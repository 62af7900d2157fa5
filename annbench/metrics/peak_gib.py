"""peak_gib: the most device memory the program held from the start of its
set-up through the window (`torch.cuda.max_memory_allocated`, reset once the
benchmark's own tensors left the card, read before the reference runs)."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
