"""The plain reference against a NumPy brute force at small sizes, on L2 and
on ties, and its recall count against the port's set arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from annbench import reference


def _numpy_knn(data, queries, k):
    d = ((queries[:, None, :].astype(np.float64) - data[None].astype(np.float64)) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("row_block", [64, 1 << 18])
def test_exact_knn_matches_numpy(monkeypatch, row_block):
    monkeypatch.setattr(reference, "ROW_BLOCK", row_block)
    monkeypatch.setattr(reference, "QUERY_BLOCK", 16)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((1000, 12)).astype(np.float32)
    q = rng.standard_normal((40, 12)).astype(np.float32)
    d, i = reference.exact_knn(torch.from_numpy(data), torch.from_numpy(q), 10)
    nd, ni = _numpy_knn(data, q, 10)
    np.testing.assert_array_equal(i.numpy(), ni)
    np.testing.assert_allclose(d.numpy(), nd, rtol=1e-5, atol=1e-4)


def test_exact_knn_on_ties():
    """Rows repeated four times tie exactly: every returned distance is the
    true one, and the returned ids are the true ids up to the tie."""
    rng = np.random.default_rng(1)
    base = rng.integers(-3, 4, (50, 8)).astype(np.float32)
    data = np.repeat(base, 4, axis=0)
    q = base[:10] + 0.25
    d, i = reference.exact_knn(torch.from_numpy(data), torch.from_numpy(q), 8)
    nd, _ = _numpy_knn(data, q, 8)
    np.testing.assert_allclose(d.numpy(), nd, rtol=1e-6, atol=1e-5)
    direct = reference.id_distances(torch.from_numpy(data), torch.from_numpy(q),
                                    torch.arange(10), i)
    np.testing.assert_allclose(direct.numpy(), nd, rtol=1e-6)
    assert all(len(set(r.tolist())) == 8 for r in i)


def test_id_distances_match_numpy():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((300, 20)).astype(np.float32)
    q = rng.standard_normal((7, 20)).astype(np.float32)
    qidx = np.array([0, 3, 3, 6])
    ids = rng.integers(0, 300, (4, 5))
    got = reference.id_distances(torch.from_numpy(data), torch.from_numpy(q),
                                 torch.from_numpy(qidx), torch.from_numpy(ids))
    want = ((q[qidx][:, None, :] - data[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_recall_hits_is_the_ports_recall():
    from flatnav_tpu_torch.bench.metrics import recall_at_k

    rng = np.random.default_rng(3)
    truth = np.stack([rng.permutation(50)[:10] for _ in range(30)])
    found = np.where(rng.random((30, 10)) < 0.7, truth, rng.integers(50, 99, (30, 10)))
    found = np.take_along_axis(found, rng.permuted(np.tile(np.arange(10), (30, 1)), axis=1), 1)
    hits = reference.recall_hits(torch.from_numpy(found), torch.from_numpy(truth))
    assert hits / truth.size == pytest.approx(recall_at_k(found, truth))


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10, -3.14159265, 1e-20])
    r = reference.tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1 + 2**-10 and r[2] == 1 + 2**-10
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2**-11).all()
