"""The beam-search hop's PyTorch chain (index/search.py: `_select`,
`_membership`, `_merge`), which the hop's CUDA kernels (csrc/beam_hop.cu)
reproduce bit for bit on the card, held to the JAX package's hop on the CPU.

Both packages search the same synthetic graph with the same per-query
distance table (tests/beam_hop_cases.py), built to reach the hop's corner
cases: ties among new distances and between beam and new entries,
duplicate neighbours in a row, neighbours already in the beam or the
history, ids outside [0, N) that score NaN, -0.0 beside +0.0, one and four
expansions a hop (rows with fewer unexpanded entries than that select
invalid sources), and compaction on and off. A hop cap of 1 or 2 stops
both after that many hops, 0 runs them to the end: beams (distances by
their bits), ids, distance computations and hops must be equal.

The JAX package's default merge ("gather", by ranks) assumes no NaN
distances; the NaN cases run its stable-sort merge, which its docstring
gives as bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beam_hop_cases as cases
import flatnav_tpu.index.search as jsearch
from flatnav_tpu_torch.index.search import beam_search_core
from flatnav_tpu_torch.ops import beam_hop

EF, NI, CW = 8, 8, 5


def _jax_blocks(table):
    n = table.shape[1]

    def score_block(ids):
        ok = (ids >= 0) & (ids < n)
        got = jnp.take_along_axis(table, jnp.clip(ids, 0, n - 1), axis=1)
        return jnp.where(ok, got, jnp.nan)

    def entry_block(cand):
        return table[:, cand]

    return score_block, entry_block


@pytest.mark.parametrize("max_hops", [1, 2, 0], ids=["hop1", "hop2", "to_the_end"])
@pytest.mark.parametrize("compact_width", [0, CW], ids=["uncompacted", "compacted"])
@pytest.mark.parametrize("expand", [1, 4], ids=["E1", "E4"])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_chain_matches_jax_hop(kind, expand, compact_width, max_hops, monkeypatch):
    links, table = cases.make(kind)
    kw = dict(ef=EF, num_initializations=NI, max_hops=max_hops, expand_factor=expand,
              compact_width=compact_width)
    if kind == "out_of_range":
        monkeypatch.setattr(jsearch, "MERGE_IMPL", "sort")
    score, entry = _jax_blocks(jnp.asarray(table))
    want = jsearch.beam_search_core(
        jnp.asarray(links), jnp.asarray(cases.N, jnp.int32), cases.B, cases.N, score,
        entry_block=entry, **kw)
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    got = beam_search_core(torch.from_numpy(links), cases.N, cases.B, score, entry, **kw)
    np.testing.assert_array_equal(got.dists.view(torch.int32).numpy(),
                                  np.asarray(want.dists).view(np.int32))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert int(got.dist_computations) == int(want.dist_computations)
    assert int(got.hops) == int(want.hops)


@pytest.mark.parametrize("kind", cases.KINDS)
def test_cases_reach_their_corner(kind):
    # each kind holds what it is named for, and every kind revisits nodes
    links, table = cases.make(kind)
    if kind == "dups":
        assert all(len(set(r)) < len(r) for r in links.tolist())
    if kind == "out_of_range":
        assert {-1, cases.N, cases.N + 5} <= set(links.ravel().tolist())
    if kind == "signed_zero":
        zeros = table[table == 0]
        assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
    assert len(np.unique(table[0])) <= 7  # ties
    score, entry = cases.torch_blocks(torch.from_numpy(table))
    got = beam_search_core(torch.from_numpy(links), cases.N, cases.B, score, entry,
                           ef=EF, num_initializations=NI, expand_factor=4)
    scored = int(got.dist_computations) - cases.B * (NI + 1)
    # some neighbours of the expanded nodes were not fresh
    assert 0 < scored < int(got.hops) * cases.M


#: an H100's dynamic shared memory a block, less the kernels' static 40 bytes
H100_SMEM = 227 * 1024 - 40


@pytest.mark.parametrize("shape,fits", [
    ((512, 64, 32, 18 * 64), True),  # sift1m.graph: ef 512, E 64, M 32
    ((192, 16, 32, 32 * 16), True),  # gist1m.graph: ef 192, E 16
    ((100, 16, 32, 20 * 16), True),  # the wave build: efc 100, E 16
    ((12_000, 16, 32, 1508 * 16), False),  # ef past shared memory (the merge's keys)
    ((512, 256, 32, 16 * 256), False),  # E*M past shared memory (membership's sets)
    ((512, 64, 32, 400 * 64), False),  # a history past shared memory (max_hops 400)
])
def test_kernels_engage_on_the_card_within_their_plan(shape, fits):
    # the kernels run every shape on the card: a row's working set in shared
    # memory where it fits, else in a global-memory workspace
    ef, e_f, m, hist = shape
    assert beam_hop.engages(torch.device("cuda"))
    assert not beam_hop.engages(torch.device("cpu"))
    row = beam_hop.scratch_row(ef, e_f, m, hist, H100_SMEM)
    assert (row == 0) is fits
    if not fits:
        assert row % 16 == 0 and row == -(-max(beam_hop.stage_bytes(ef, e_f, m, hist).values())
                                          // 16) * 16


def test_kernels_refuse_cpu_tensors():
    count = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        beam_hop.BeamHop(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32),
                         torch.ones((2, 8), dtype=torch.bool),
                         torch.full((2, 16), -1, dtype=torch.int32), count, count, e_f=4, m=2)
