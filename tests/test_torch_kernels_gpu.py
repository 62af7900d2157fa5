"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports neither JAX nor flatnav_tpu, so on a machine
with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

K2 and 8-bit K1 must be bit-equal to the plain version. bf16 K1 sums its
products in another order than cuBLAS, so its minima agree within 1e-5 of
the largest key magnitude and its ids on >= 99% of buckets.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu_torch
from flatnav_tpu_torch.ops.distances import MetricType, squared_norms
from flatnav_tpu_torch.ops.fused_scan import scan_buckets, scan_buckets_plain
from flatnav_tpu_torch.ops.gather_distance import (
    gather_distances,
    gather_distances_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0xF1A7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [7, 37, 128, 960])
def test_gather_distances_bit_equal(cuda, rng, d, metric, dtype):
    n, b, c = 2000, 37, 129  # ragged B x C
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda, dtype)
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    before = gather_distances.launches
    got = gather_distances(v, i, q, metric)
    assert gather_distances.launches == before + 1
    assert torch.equal(got, gather_distances_plain(v, i, q, metric))


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("d", [37, 128])
def test_scan_buckets_matches_plain(cuda, rng, d, dtype, metric):
    n, nlim, qc, t, L = 10000, 9000, 100, 2048, 16  # n not a multiple of t
    if dtype == torch.bfloat16:
        rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda, dtype)
        q = torch.from_numpy(rng.standard_normal((qc, d)).astype(np.float32)).to(cuda, dtype)
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        rows = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype(np.int16)).to(cuda, dtype)
        q = torch.from_numpy(rng.integers(lo, hi, (qc, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    before = scan_buckets.launches
    kmin, kid = scan_buckets(q, rows, pen, nlim, t, L)
    assert scan_buckets.launches == before + 1
    pmin, pid = scan_buckets_plain(q, rows, pen, nlim, t, L)
    if dtype != torch.bfloat16:
        assert torch.equal(kmin, pmin) and torch.equal(kid, pid)
    else:
        fin = torch.isfinite(pmin)
        assert torch.equal(fin, torch.isfinite(kmin))
        tol = 1e-5 * float(pmin[fin].abs().max())
        assert float((kmin[fin] - pmin[fin]).abs().max()) <= tol
        assert float((kid == pid).float().mean()) >= 0.99


def test_lifecycle_on_card(cuda, tmp_path):
    rng = np.random.default_rng(11)
    data = rng.standard_normal((3000, 32), dtype=np.float32)
    q = rng.standard_normal((64, 32), dtype=np.float32)
    g0, s0 = gather_distances.launches, scan_buckets.launches
    ix = flatnav_tpu_torch.index.create("l2", 32, 3000, 16)
    assert ix.device.type == "cuda"
    ix.add(data, ef_construction=64)
    d1, l1 = ix.search(q, K=10, ef_search=64)
    ix.search_exact(q, K=10, rerank=32)
    assert gather_distances.launches > g0 and scan_buckets.launches > s0
    ix.save(str(tmp_path / "g.npz"))
    d2, l2 = flatnav_tpu_torch.index.load_index(str(tmp_path / "g.npz")).search(q, 10, 64)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(d1, d2)
