"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports neither JAX nor flatnav_tpu, so on a machine
with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

K2 and 8-bit K1 must be bit-equal to the plain version. bf16 K1 sums its
products in another order than cuBLAS, so its minima agree within 1e-5 of
the largest key magnitude and its ids on >= 99% of buckets. K1 has two
variants chosen by shape ("wgmma" and "mma"); each case states which one
it must take.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu_torch
from flatnav_tpu_torch.ops.distances import MetricType, squared_norms
from flatnav_tpu_torch.ops.fused_scan import scan_buckets, scan_buckets_plain
from flatnav_tpu_torch.ops.gather_distance import gather_distances, gather_distances_plain

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


K2_DS = [1, 7, 31, 32, 33, 64, 128, 129, 130, 960, 1024, 2048, 3072, 4096]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", K2_DS)
def test_gather_distances_register_tree(cuda, rng, d, dtype):
    # every width class of the register tree: shuffles only (p <= 32), 1 to
    # 32 in-lane levels, and p = 4096 with its top level folded into the
    # loads; 16-bit rows of even d take the paired 4-byte loads. L2 on even
    # d, IP on odd
    metric = MetricType.L2 if d % 2 == 0 else MetricType.IP
    n, b, c = 3000, 19, 300
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda, dtype)
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    assert torch.equal(gather_distances(v, i, q, metric), gather_distances_plain(v, i, q, metric))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 130])
def test_gather_distances_unaligned_16bit_table(cuda, rng, d, dtype):
    # a table view one element into its storage is 2-byte aligned: the
    # kernel must read it element by element, not in 4-byte pairs
    n, b, c = 3000, 9, 257
    full = torch.from_numpy(rng.standard_normal((n * d + 1,), dtype=np.float32)).to(cuda, dtype)
    v = full[1:].view(n, d)
    assert v.data_ptr() % 4 == 2
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    assert torch.equal(gather_distances(v, i, q), gather_distances_plain(v, i, q))


@pytest.mark.parametrize("d", [7, 128, 960])
def test_gather_distances_out_of_range_ids_are_nan(cuda, rng, d):
    n, b, c = 500, 8, 200
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    bad = rng.random((b, c)) < 0.2
    ids[bad] = rng.choice(np.array([-1, -7, n, n + 3, 2**31 - 1], np.int32), int(bad.sum()))
    i = torch.from_numpy(ids).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    got = gather_distances(v, i, q)
    bad_t = torch.from_numpy(bad).to(cuda)
    assert bool(torch.isnan(got[bad_t]).all())
    want = gather_distances_plain(v, i.clamp(0, n - 1), q)
    assert torch.equal(got[~bad_t], want[~bad_t])


@pytest.mark.parametrize("c", [1024, 1021, 1000])
def test_gather_distances_build_wave_width(cuda, rng, c):
    # C = 1024 as in a build wave, and C with a tail of rows per warp
    n, b, d = 4000, 64, 128
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    i = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    assert torch.equal(gather_distances(v, i, q), gather_distances_plain(v, i, q))


def _scan_case(rng, cuda, n, d, qc, dtype):
    if dtype == torch.bfloat16:
        rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda, dtype)
        q = torch.from_numpy(rng.standard_normal((qc, d)).astype(np.float32)).to(cuda, dtype)
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        rows = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype(np.int16)).to(cuda, dtype)
        q = torch.from_numpy(rng.integers(lo, hi, (qc, d)).astype(np.float32)).to(cuda, torch.bfloat16)
    return rows, q


def _check_scan(q, rows, pen, nlim, t, L, variant):
    before = scan_buckets.launches, scan_buckets.variants[variant]
    kmin, kid = scan_buckets(q, rows, pen, nlim, t, L)
    assert (scan_buckets.launches, scan_buckets.variants[variant]) == (before[0] + 1, before[1] + 1)
    pmin, pid = scan_buckets_plain(q, rows, pen, nlim, t, L)
    if rows.dtype != torch.bfloat16:
        assert torch.equal(kmin, pmin) and torch.equal(kid, pid)
    else:
        fin = torch.isfinite(pmin)
        assert torch.equal(fin, torch.isfinite(kmin))
        tol = 1e-5 * float(pmin[fin].abs().max())
        assert float((kmin[fin] - pmin[fin]).abs().max()) <= tol
        assert float((kid == pid).float().mean()) >= 0.99


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("d", [37, 128])
def test_scan_buckets_matches_plain(cuda, rng, d, dtype, metric):
    n, nlim, qc, t, L = 10000, 9000, 100, 2048, 16  # n not a multiple of t
    rows, q = _scan_case(rng, cuda, n, d, qc, dtype)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    variant = "wgmma" if dtype == torch.bfloat16 and d == 128 else "mma"
    _check_scan(q, rows, pen, nlim, t, L, variant)


@pytest.mark.parametrize("t,L", [(2048, 16), (2048, 4), (4096, 32), (1024, 1), (1536, 3)])
@pytest.mark.parametrize("d", [64, 128, 256, 384])
def test_scan_buckets_wgmma_shapes(cuda, rng, d, t, L):
    # n not a multiple of T, n_valid < N, a query count that is not a
    # multiple of the block's 128, and S = T/L of 1-4 bucket blocks
    n, nlim, qc = 13_000, 12_345, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "wgmma")


@pytest.mark.parametrize("d", [40, 56, 392])
def test_scan_buckets_other_bf16_widths_take_mma(cuda, rng, d):
    n, nlim, qc, t, L = 5000, 4900, 70, 2048, 16
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "mma")


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
