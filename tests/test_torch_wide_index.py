"""The port's Index at widths past the gather kernel's register path,
against flatnav_tpu on the CPU: OpenAI's d = 1536 and a width past 4096,
where the JAX package's gather pads its tree to any power of two and the
port's kernel forms the same tree through a carry stack (on the CPU both
run the same plain reduction).

The parity rules are those of tests/test_torch_index.py. Both packages take
the rows in adds of 32: each wave then touches at most 32 * M back-edge
targets, and the back-edge step pads a wave of more than 256 targets to
16,384 of them (its canonical shape), a [16384, M + 32, d] distance block
that at these widths takes tens of GB on the CPU.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu
import flatnav_tpu_torch
from flatnav_tpu_torch import convert
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.ops import brute_force_knn

N, M, EFC, K, EF, ADD = 1000, 8, 32, 10, 64, 32


def _recall(found, truth):
    return sum(len(set(f) & set(t)) for f, t in zip(found, truth)) / truth.size


@pytest.fixture(scope="module", params=[1536, 5000])
def built(request, tmp_path_factory):
    """Same data and insertion order through both packages; the JAX index
    saved and loaded by the port as well."""
    d = request.param
    data, queries = clustered(N, d, 16, seed=d)
    jx = flatnav_tpu.index.create("l2", dim=d, dataset_size=N, max_edges_per_node=M)
    px = flatnav_tpu_torch.index.create("l2", dim=d, dataset_size=N, max_edges_per_node=M,
                                        device="cpu")
    for lo in range(0, N, ADD):
        jx.add(data[lo : lo + ADD], ef_construction=EFC)
        px.add(data[lo : lo + ADD], ef_construction=EFC)
    path = str(tmp_path_factory.mktemp(f"wide{d}") / "jax.npz")
    jx.save(path)
    from_jax = convert.index_from_jax_npz(path, device="cpu")
    _, truth = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), K)
    return queries, jx, px, from_jax, truth.numpy()


def test_jax_built_graph_searched_by_both(built):
    queries, jx, _, from_jax, _ = built
    jd, jl = jx.search(queries, K=K, ef_search=EF)
    pd, pl = from_jax.search(queries, K=K, ef_search=EF)
    same = (pl == jl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(pd[same], jd[same], rtol=1e-6)


def test_port_built_graph_recall_matches_jax(built):
    queries, jx, px, _, truth = built
    _, jl = jx.search(queries, K=K, ef_search=EF)
    _, pl = px.search(queries, K=K, ef_search=EF)
    assert px.num_nodes == jx.num_nodes == N
    assert abs(_recall(pl, truth) - _recall(jl, truth)) <= 0.02


def test_search_exact_engines_match_jax(built):
    queries, jx, px, _, truth = built
    for kw in (dict(), dict(rerank=32)):
        jd, jl = jx.search_exact(queries, K=K, **kw)
        pd, pl = px.search_exact(queries, K=K, **kw)
        assert (pl == jl).mean() >= 0.99, kw
        np.testing.assert_allclose(pd[pl == jl], jd[pl == jl], rtol=1e-5)
    _, pl = px.search_exact(queries, K=K)
    assert _recall(pl, truth) == 1.0
