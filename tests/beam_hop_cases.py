"""Synthetic hop inputs for the beam-hop tests: a small random graph whose
neighbour lists and per-query distances are drawn to reach the hop's corner
cases. Shared by the CPU tests (the PyTorch chain against the JAX package)
and the card's (each kernel against its stage of the chain); imports
neither JAX nor a card.

Kinds: "ties" (distances from six values, so new entries tie with each other
and with beam entries), "dups" (each neighbour list repeats its ids),
"out_of_range" (lists hold -1, N and N + 5, which score NaN),
"signed_zero" (distances -0.0 and +0.0 among ties). Every kind revisits
nodes: 48 nodes, 8 links each, beams of 8.
"""

import numpy as np
import torch

N, B, M = 48, 6, 8
KINDS = ("ties", "dups", "out_of_range", "signed_zero")


def make(kind: str, seed: int = 0):
    """-> (links [N, M] int32, table [B, N] float32) as numpy arrays."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    links = rng.integers(0, N, (N, M)).astype(np.int32)
    table = (rng.integers(0, 6, (B, N)) * 0.25).astype(np.float32)
    if kind == "dups":
        links[:, M // 2 :] = links[:, : M // 2][:, rng.permutation(M // 2)]
    elif kind == "out_of_range":
        bad = rng.random((N, M)) < 0.2
        links[bad] = rng.choice(np.array([-1, N, N + 5], np.int32), int(bad.sum()))
    elif kind == "signed_zero":
        table[rng.random((B, N)) < 0.3] = 0.0
        table[(table == 0) & (rng.random((B, N)) < 0.5)] = -0.0
    return links, table


def torch_blocks(table: torch.Tensor):
    """(score_block, entry_block) of `beam_search_core` over a [B, N]
    distance table: ids outside [0, N) score NaN, as K2 scores them."""
    n = table.shape[1]

    def score_block(ids):
        ok = (ids >= 0) & (ids < n)
        got = table.gather(1, ids.clamp(0, n - 1).long())
        return torch.where(ok, got, float("nan"))

    def entry_block(cand):
        return table[:, cand.long()]

    return score_block, entry_block
