"""The stage profiler's stages (flatnav_tpu_torch/bench/profile_fused_stages.py)
on CPU tensors, held against the port's plain scan and against the JAX
package's `fused_knn` in Pallas interpret mode, with the same explicit
bucket_l / tile_size / rerank.

Tolerances are those of tests/test_torch_fused_scan.py: float tables go
through bf16 keys whose f32 sums are taken in another order, and phase B is
an exact top-k where JAX uses approx_min_k, so ids agree on >= 99% of
(query, rank) slots and the distances of shared ids within rtol 1e-6 (with
atol 1e-4 where they are calibrated from keys).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.ops import MetricType as JMetric
from flatnav_tpu.ops import fused_knn as jax_fused
from flatnav_tpu_torch.bench import profile_fused_stages as pfs
from flatnav_tpu_torch.bench.synth import clustered
from flatnav_tpu_torch.ops.distances import query_block_distances, squared_norms
from flatnav_tpu_torch.ops.fused_scan import scan_buckets_plain

K, RERANK, L, TILE = 10, 32, 4, 2048


@pytest.fixture(scope="module")
def case():
    data, q = clustered(8000, 32, 48)
    fns, shapes = pfs.stages(torch.from_numpy(data), torch.from_numpy(q), K, RERANK, L, TILE)
    return data, q, fns, shapes


def _jax(data, q, k, rerank, exact):
    d, i = jax_fused(jnp.asarray(data), jnp.asarray(q), k, JMetric.L2, rerank=rerank,
                     bucket_l=L, tile_size=TILE, interpret=True, exact_rerank=exact)
    return np.asarray(d), np.asarray(i)


def _agree(td, ti, jd, ji, atol):
    assert (ti == ji).mean() >= 0.99
    shared = ti == ji
    np.testing.assert_allclose(td[shared], jd[shared], rtol=1e-6, atol=atol)


def test_phase_a_is_the_plain_scan(case):
    data, q, fns, (l, t, qc) = case
    assert (l, t) == (L, TILE) and qc >= q.shape[0]
    ds_bf = torch.from_numpy(data).to(torch.bfloat16)
    (bmin, bids), = fns["phaseA"]()
    pmin, pid = scan_buckets_plain(torch.from_numpy(q).to(torch.bfloat16), ds_bf,
                                   squared_norms(ds_bf), data.shape[0], t, l)
    assert torch.equal(bmin, pmin) and torch.equal(bids, pid)


def test_matmul_yardstick_is_the_row_minimum(case):
    data, q, fns, _ = case
    want = (torch.from_numpy(q).to(torch.bfloat16) @ torch.from_numpy(data).to(torch.bfloat16).T)
    assert torch.equal(fns["matmul"](), want.amin(dim=1))


def test_phase_ab_shortlist_matches_jax(case):
    # JAX ranks the same shortlist by its keys with k = rerank, and returns
    # them calibrated (key + ||q||^2)
    data, q, fns, _ = case
    keys, ids = fns["phaseAB"]()
    assert keys.shape == ids.shape == (q.shape[0], RERANK)
    jd, ji = _jax(data, q, RERANK, RERANK, exact=False)
    td = (keys + squared_norms(torch.from_numpy(q))[:, None]).numpy()
    _agree(td, ids.numpy(), jd, ji, atol=1e-4)


@pytest.mark.parametrize("stage,exact,atol", [("norerank", False, 1e-4), ("full", True, 0.0)])
def test_knn_stages_match_jax(case, stage, exact, atol):
    data, q, fns, _ = case
    td, ti = fns[stage]()
    jd, ji = _jax(data, q, K, RERANK, exact)
    _agree(td.numpy(), ti.numpy(), jd, ji, atol)


def test_gather_stage_is_rescore_and_stable_sort(case):
    data, q, fns, _ = case
    cand = np.random.default_rng(0).integers(0, data.shape[0], (q.shape[0], RERANK)).astype(np.int32)
    ex = query_block_distances(torch.from_numpy(q), torch.from_numpy(data[cand]), pfs.MetricType.L2)
    order = np.argsort(ex.numpy(), axis=1, kind="stable")[:, :K]
    gd, gi = fns["gather"]()
    assert torch.equal(gd, torch.from_numpy(np.take_along_axis(ex.numpy(), order, 1)))
    np.testing.assert_array_equal(gi.numpy(), np.take_along_axis(cand, order, 1))


def test_main_needs_a_card(monkeypatch):
    # without a CUDA device the tool refuses before any work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pfs.main(["--n", "1000", "--d", "8", "--b", "4"]) == 2
