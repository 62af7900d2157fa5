"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports neither JAX nor flatnav_tpu, so on a machine
with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

K2 must be bit-equal to the plain version, and so must K1 on 8-bit rows
against 8-bit or integer-valued bf16 queries (every partial sum is an
integer below 2^24). Other K1 cases sum their products in another order
than cuBLAS, so their minima agree within 1e-5 of the largest key
magnitude and their ids on >= 99% of buckets. K1 has eight variants chosen
by shape and type ("wgmma_narrow", "wgmma", "wgmma_wide", "wgmma_deep",
"wgmma_int8", "wgmma_int8_packed", "wgmma_mixed" and "mma"); each case
states which one it must take. K2 is held at every width class, past
d = 4096 too (its carry-stack path). K3 must be bit-equal on
both routes ("block": bulk copies, also of rows off a 16-byte boundary;
"warp": a warp a row), seeded with a prior or not, and the scans must
return what the two-launch merge they replaced returns.

The hop's kernels (csrc/beam_hop.cu) must give what their stages of the
PyTorch chain give, bit for bit, after every stage of every hop: on the
corner cases of tests/beam_hop_cases.py, at the graph cells' shapes and at
shapes whose rows outgrow shared memory (the global-memory workspace); and
a search or a build must give the same bits whether the hops ran the
kernels or the chain.

The product-quantized index and the graph reordering hold no kernel of their
own; their cases run the same call on the card and with device="cpu" at a
small size and hold the two together, at the tolerances of the CPU tests
against the JAX package.
"""

import numpy as np
import pytest
import torch

import flatnav_tpu_torch
from flatnav_tpu_torch.bench.kernel_ab import hop_lockstep
from flatnav_tpu_torch.ops.distances import MetricType, brute_force_knn, squared_norms
from flatnav_tpu_torch.ops import fused_scan
from flatnav_tpu_torch.ops.fused_scan import (
    _ROW_TYPES, VARIANTS, exact_keys, fused_knn, scan_buckets, scan_buckets_plain, scan_operands,
)
from flatnav_tpu_torch.ops.gather_distance import gather_distances, gather_distances_plain
from flatnav_tpu_torch.quantization import PQIndex, ProductQuantizer, pack_codes_4bit, pack_codes_lanes
from flatnav_tpu_torch.quantization.pq import PQCodebook, pq_scan_knn

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


@pytest.mark.parametrize("d", [7, 128, 960, 5000])
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


#: K2 past the register path: p = 4096 and wider, d not a power of two
#: (zero terms past d), OpenAI's 3072 and the widest the tests hold
K2_DEEP_DS = [2049, 3072, 4096, 4097, 5000, 8192, 16384]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", K2_DEEP_DS)
def test_gather_distances_deep_widths_bit_equal(cuda, rng, d, metric, dtype):
    # ragged B x C, a few candidates past the table (NaN), every other one
    # in range; 16-bit rows of even d take the paired loads, odd d single ones
    n, b, c = 600, 5, 131
    v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(cuda, dtype)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    ids[:, ::29] = n + 1
    i = torch.from_numpy(ids).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    before = gather_distances.launches
    got = gather_distances(v, i, q, metric)
    assert gather_distances.launches == before + 1
    bad = i >= n
    assert bool(torch.isnan(got[bad]).all())
    want = gather_distances_plain(v, i.clamp(max=n - 1), q, metric)
    assert torch.equal(got[~bad], want[~bad])


def test_index_at_d5000_on_card_matches_cpu(cuda):
    # a float index wider than 4096: the build's waves and the search's hops
    # go through K2's carry-stack path on the card and give the CPU's ids;
    # a result that is an entry point carries the entry scan's matmul
    # distance, summed in another order by cuBLAS than on the CPU
    rng = np.random.default_rng(5)
    data = rng.standard_normal((1000, 5000), dtype=np.float32)
    q = rng.standard_normal((32, 5000), dtype=np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        ix = flatnav_tpu_torch.index.create("l2", 5000, 1000, 16, device=dev)
        g0 = gather_distances.launches
        ix.add(data, ef_construction=64)
        out[dev] = ix.search(q, K=10, ef_search=64)
        if dev == "cuda":
            assert gather_distances.launches > g0
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-6)


def _scan_case(rng, cuda, n, d, qc, dtype, qdtype=torch.bfloat16, queries="int"):
    """Normal bf16 rows and queries, or uniform 8-bit rows with queries of
    `qdtype` that are integers of the rows' range ("int") or normal bf16
    values of about that spread ("normal")."""
    if dtype == torch.bfloat16:
        rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda, dtype)
        q = torch.from_numpy(rng.standard_normal((qc, d)).astype(np.float32)).to(cuda, dtype)
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        rows = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype(np.int16)).to(cuda, dtype)
        if queries == "int":
            q = torch.from_numpy(rng.integers(lo, hi, (qc, d)).astype(np.int16)).to(cuda, qdtype)
        else:
            q = (lo + hi) / 2 + 50 * rng.standard_normal((qc, d))
            q = torch.from_numpy(q.astype(np.float32)).to(cuda, qdtype)
    return rows, q


def _check_scan(q, rows, pen, nlim, t, L, variant):
    before = scan_buckets.launches, scan_buckets.variants[variant]
    kmin, kid = scan_buckets(q, rows, pen, nlim, t, L)
    assert (scan_buckets.launches, scan_buckets.variants[variant]) == (before[0] + 1, before[1] + 1)
    pmin, pid = scan_buckets_plain(q, rows, pen, nlim, t, L)
    if exact_keys(q, rows):
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
    # 8-bit rows against bf16 queries: "wgmma_mixed" at d = 128, "mma" at a
    # width of d % 4 != 0
    variant = ("mma" if d == 37 else "wgmma" if dtype == torch.bfloat16 else "wgmma_mixed")
    _check_scan(q, rows, pen, nlim, t, L, variant)


@pytest.mark.parametrize("t,L", [(2048, 16), (2048, 4), (4096, 32), (1024, 1), (1536, 3)])
@pytest.mark.parametrize("d", [64, 128, 256, 384])
def test_scan_buckets_wgmma_shapes(cuda, rng, d, t, L):
    # n not a multiple of T, n_valid < N, a query count that is not a
    # multiple of the block's 128, and S = T/L of 1-4 bucket blocks
    n, nlim, qc = 13_000, 12_345, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "wgmma")


@pytest.mark.parametrize("d", [37, 44])
def test_scan_buckets_other_bf16_widths_take_mma(cuda, rng, d):
    # rows of a byte width TMA cannot stride (d = 40 and 56 take "wgmma"
    # now: test_scan_buckets_narrow_bf16_widths; d past 1024 "wgmma_deep":
    # test_scan_buckets_wgmma_deep)
    n, nlim, qc, t, L = 5000, 4900, 70, 2048, 16
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "mma")


@pytest.mark.parametrize("t,L", [(256, 1), (4096, 32), (32768, 256)])
@pytest.mark.parametrize("d,want", [(8, "wgmma_narrow"), (16, "wgmma_narrow"),
                                    (32, "wgmma_narrow"), (40, "wgmma"), (56, "wgmma")])
def test_scan_buckets_narrow_bf16_widths(cuda, rng, d, want, t, L):
    # bf16 under 64 columns: 64-byte rows up to d = 32, else "wgmma"'s
    # 64-column boxes with the columns past d read as zeros
    n, nlim, qc = 40_037, 39_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, want)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [25, 50])
def test_scan_buckets_glove_widths_through_scan_operands(cuda, rng, d, metric):
    # GloVe-25 and -50 as fused_knn hands them over: copies of 32 and 56
    # columns, T=4096 and L=32 as it picks them at 1.18M rows
    n, nlim, qc = 30_011, 30_011, 200
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    rows, q = scan_operands(rows, q)
    assert rows.shape[1] == (32 if d == 25 else 56)
    pen = squared_norms(rows[:, :d]) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    _check_scan(q, rows, pen, nlim, 4096, 32, "wgmma_narrow" if d == 25 else "wgmma")


#: (T, L) of the new variants' cases: one slice, the default, eight bits of slices
NEW_TL = [(256, 1), (2048, 16), (32768, 256)]


@pytest.mark.parametrize("t,L", NEW_TL)
@pytest.mark.parametrize("d", [392, 960, 1024])
def test_scan_buckets_wgmma_wide(cuda, rng, d, t, L):
    # n not a multiple of T, n_valid < N, and 300 queries: not a multiple of
    # a block's 64, nor of a cluster's 128 (the last cluster's second block
    # holds no query)
    n, nlim, qc = 40_037, 39_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "wgmma_wide")


@pytest.mark.parametrize("t,L", NEW_TL)
@pytest.mark.parametrize("d", [1032, 1536, 3072, 4104])
def test_scan_buckets_wgmma_deep(cuda, rng, d, t, L):
    # bf16 past d = 1024: both operands stream through the ring. n not a
    # multiple of T, n_valid < N, 300 queries (not a multiple of a block's
    # 128, nor of a cluster's); the variant count shows "wgmma_deep" alone
    n, nlim, qc = 20_037, 19_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    before = dict(scan_buckets.variants)
    _check_scan(q, rows, squared_norms(rows), nlim, t, L, "wgmma_deep")
    after = dict(scan_buckets.variants)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {"wgmma_deep": 1}


@pytest.mark.parametrize("t,L", NEW_TL)
@pytest.mark.parametrize("d", [100, 104])
def test_scan_buckets_padded_width_takes_wgmma(cuda, rng, d, t, L):
    # angular's d=100 reaches the kernel as fused_knn pads it: d=104
    n, nlim, qc = 40_037, 39_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, torch.bfloat16)
    rows, q = scan_operands(rows, q)
    assert rows.shape[1] == 104
    _check_scan(q, rows, squared_norms(rows[:, :d]), nlim, t, L, "wgmma")


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("t,L", NEW_TL)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_scan_buckets_wgmma_int8(cuda, rng, dtype, d, t, L, metric):
    n, nlim, qc = 40_037, 39_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, dtype, qdtype=dtype)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    _check_scan(q, rows, pen, nlim, t, L, "wgmma_int8")  # bit-equal


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("t,L", NEW_TL)
@pytest.mark.parametrize("d", [4, 36, 100, 164, 252])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_scan_buckets_wgmma_int8_packed(cuda, rng, dtype, d, t, L, metric):
    # rows of d % 16 != 0 bytes (MS SPACEV's d = 100), one and two depth
    # chunks; n not a multiple of T and n_valid < N
    n, nlim, qc = 40_037, 39_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, dtype, qdtype=dtype)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    _check_scan(q, rows, pen, nlim, t, L, "wgmma_int8_packed")  # bit-equal


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_scan_buckets_packed_width_off_16_bytes_takes_mma(cuda, rng, dtype):
    # a table slice whose base is 4 bytes past a 16-byte boundary: no TMA or
    # packed variant takes it, and "mma" stays bit-equal
    n, nlim, qc, d = 5000, 4900, 70, 100
    rows, q = _scan_case(rng, cuda, n, d, qc, dtype, qdtype=dtype)
    flat = torch.empty(n * d + 16, dtype=dtype, device=cuda)
    view = flat[4 : 4 + n * d].view(n, d)
    view.copy_(rows)
    assert view.data_ptr() % 16 == 4
    _check_scan(q, view, squared_norms(view), nlim, 2048, 16, "mma")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_scan_buckets_bf16_queries_of_8bit_rows_take_wgmma_mixed(cuda, rng, dtype):
    rows, q = _scan_case(rng, cuda, 5000, 128, 70, dtype)
    _check_scan(q, rows, squared_norms(rows), 4900, 2048, 16, "wgmma_mixed")


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("queries", ["int", "normal"])
@pytest.mark.parametrize("t,L", [(2048, 16), (32768, 256)])
@pytest.mark.parametrize("d", [16, 64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_scan_buckets_wgmma_mixed(cuda, rng, dtype, d, t, L, queries, metric):
    # 8-bit rows against bf16 queries: TMA rows (d % 16 == 0) and the packed
    # copies (d = 100), one to four 64-column groups; n not a multiple of T,
    # n_valid < N, 300 queries (not a multiple of the block's 128);
    # bit-equal with integer-valued queries, within tolerance with normal
    # ones; the variant count shows "wgmma_mixed" alone
    n, nlim, qc = 40_037, 39_000, 300
    rows, q = _scan_case(rng, cuda, n, d, qc, dtype, queries=queries)
    pen = squared_norms(rows) if metric == MetricType.L2 else torch.zeros(n, device=cuda)
    before = dict(scan_buckets.variants)
    _check_scan(q, rows, pen, nlim, t, L, "wgmma_mixed")
    after = dict(scan_buckets.variants)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {"wgmma_mixed": 1}


#: launches of the repeated 10M check
MIXED_REPEATS = 50


@pytest.mark.parametrize("dtype,d", [(torch.uint8, 128), (torch.int8, 100)])
def test_scan_buckets_wgmma_mixed_repeats_bit_equal_at_10m(cuda, dtype, d):
    # BigANN's (TMA rows) and MS SPACEV's (packed copies) 10M rows against
    # 4,096 integer-valued bf16 queries, T=32768, L=256: every ring buffer is
    # refilled 256 times a block. MIXED_REPEATS launches in a row, each bit-equal
    # to the plain version, so a fault between the consumers' reads of a
    # buffer and its next fill shows as a run that differs
    n, qc, t, L = 10_000_000, 4096, 32768, 256
    g = torch.Generator(device=cuda).manual_seed(d)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    rows = torch.randint(lo, hi, (n, d), generator=g, device=cuda, dtype=torch.int16).to(dtype)
    q = torch.randint(lo, hi, (qc, d), generator=g, device=cuda, dtype=torch.int16)
    q = q.to(torch.bfloat16)
    pen = squared_norms(rows)
    assert exact_keys(q, rows)
    pmin, pid = scan_buckets_plain(q, rows, pen, n, t, L)
    before = scan_buckets.variants["wgmma_mixed"]
    differ = 0
    for _ in range(MIXED_REPEATS):
        kmin, kid = scan_buckets(q, rows, pen, n, t, L)
        differ += not (torch.equal(kmin, pmin) and torch.equal(kid, pid))
        del kmin, kid
    assert scan_buckets.variants["wgmma_mixed"] == before + MIXED_REPEATS
    assert differ == 0, f"{differ} of {MIXED_REPEATS} launches differ from the plain version"


@pytest.mark.parametrize("variant,dtype,qdtype,d,t,L", [
    ("wgmma_wide", torch.bfloat16, torch.bfloat16, 128, 2048, 16),
    ("wgmma_wide", torch.bfloat16, torch.bfloat16, 1032, 2048, 16),
    ("wgmma", torch.bfloat16, torch.bfloat16, 960, 2048, 16),
    ("wgmma", torch.bfloat16, torch.bfloat16, 100, 2048, 16),
    ("wgmma_int8", torch.uint8, torch.uint8, 264, 2048, 16),
    ("wgmma_int8", torch.uint8, torch.uint8, 136, 2048, 16),
    ("wgmma_int8", torch.uint8, torch.bfloat16, 128, 2048, 16),
    ("wgmma_int8", torch.bfloat16, torch.bfloat16, 128, 2048, 16),
    ("wgmma_int8", torch.uint8, torch.uint8, 128, 2048 * 32, 512),
    ("wgmma_int8_packed", torch.uint8, torch.uint8, 128, 2048, 16),
    ("wgmma_int8_packed", torch.int8, torch.int8, 102, 2048, 16),
    ("wgmma_int8_packed", torch.int8, torch.int8, 260, 2048, 16),
    ("wgmma_int8_packed", torch.uint8, torch.bfloat16, 100, 2048, 16),
    ("wgmma_int8_packed", torch.int8, torch.int8, 100, 2048 * 32, 512),
    ("wgmma_narrow", torch.bfloat16, torch.bfloat16, 40, 2048, 16),
    ("wgmma_narrow", torch.uint8, torch.uint8, 32, 2048, 16),
    ("wgmma_deep", torch.bfloat16, torch.bfloat16, 1024, 2048, 16),
    ("wgmma_deep", torch.bfloat16, torch.bfloat16, 1540, 2048, 16),
    ("wgmma_deep", torch.uint8, torch.uint8, 1536, 2048, 16),
    ("wgmma_deep", torch.bfloat16, torch.bfloat16, 1536, 2048 * 32, 512),
    ("wgmma_wide", torch.bfloat16, torch.bfloat16, 1536, 2048, 16),
    ("mma", torch.uint8, torch.uint8, 128, 2048, 16),
    ("wgmma_mixed", torch.bfloat16, torch.bfloat16, 128, 2048, 16),
    ("wgmma_mixed", torch.uint8, torch.uint8, 128, 2048, 16),
    ("wgmma_mixed", torch.int8, torch.uint8, 128, 2048, 16),
    ("wgmma_mixed", torch.uint8, torch.bfloat16, 37, 2048, 16),
    ("wgmma_mixed", torch.int8, torch.bfloat16, 128, 2048 * 32, 512),
    ("wgmma_mixed", torch.uint8, torch.bfloat16, 260, 2048, 16),
])
def test_scan_launch_outside_a_rule_raises(cuda, rng, monkeypatch, variant, dtype, qdtype, d, t, L):
    # the C entry refuses the shape or type, and the wrapper raises; nothing
    # falls back to another variant
    rows, q = _scan_case(rng, cuda, 3000, d, 40, dtype, qdtype=qdtype)
    monkeypatch.setattr(fused_scan, "scan_variant", lambda *a: variant)
    if qdtype != torch.bfloat16 and variant in ("mma", "wgmma_mixed"):
        # the wrapper widens 8-bit queries for these two: call the entry
        rc = fused_scan._lib()(
            q.data_ptr(), _ROW_TYPES[qdtype], rows.data_ptr(), _ROW_TYPES[dtype],
            squared_norms(rows).data_ptr(), 40, 3000, d, 3000, t, L,
            -(-3000 // t) * (t // L), VARIANTS[variant], 0, 0,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 1  # cudaErrorInvalidValue
        return
    before = dict(scan_buckets.variants)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        scan_buckets(q, rows, squared_norms(rows), 3000, t, L)
    assert scan_buckets.variants == before


@pytest.mark.parametrize("case", ["angular d=100 IP", "uint8 d=128", "int8 d=128", "bf16 d=960",
                                  "int8 d=100", "uint8 d=100 IP", "glove d=25 IP",
                                  "glove d=50 IP", "openai d=1536 IP", "openai d=3072 IP"])
def test_fused_knn_on_card_matches_cpu(cuda, rng, case):
    # the north-star shapes and MS SPACEV's and GloVe's through fused_knn:
    # the card against the CPU's plain scan on the same inputs
    n, nq, k = 20_000, 96, 10
    metric = MetricType.IP if "IP" in case else MetricType.L2
    d = int(case.split("d=")[1].split()[0])
    if "8" in case.split()[0]:
        dtype = torch.uint8 if case.startswith("uint8") else torch.int8
        lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
        data = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype(np.int16)).to(dtype)
        q = torch.from_numpy(rng.integers(lo, hi, (nq, d)).astype(np.int16)).to(dtype)
        want = "wgmma_int8" if d % 16 == 0 else "wgmma_int8_packed"
    else:
        data = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
        if metric == MetricType.IP:
            data = data / data.norm(dim=1, keepdim=True)
            q = q / q.norm(dim=1, keepdim=True)
        want = {100: "wgmma", 960: "wgmma_wide", 25: "wgmma_narrow", 50: "wgmma",
                1536: "wgmma_deep", 3072: "wgmma_deep"}[d]
    before = dict(scan_buckets.variants)
    gd, gi = fused_knn(data.to(cuda), q.to(cuda), k, metric)
    assert scan_buckets.variants[want] > before[want]
    assert sum(scan_buckets.variants.values()) - sum(before.values()) == scan_buckets.variants[want] - before[want]
    cd, ci = fused_knn(data, q, k, metric)
    if data.dtype != torch.float32:
        assert torch.equal(gi.cpu(), ci) and torch.equal(gd.cpu(), cd)
    else:
        same = gi.cpu() == ci
        assert float(same.float().mean()) >= 0.99
        torch.testing.assert_close(gd.cpu()[same], cd[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", [MetricType.L2, MetricType.IP])
@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_fused_knn_float_queries_on_8bit_table_on_card_matches_cpu(cuda, rng, dtype, d, metric):
    # float32 queries (table rows plus normal noise) of a BigANN- or
    # SPACEV-class table: K1 takes "wgmma_mixed" alone on the card, and the
    # ids and exact distances are the CPU's plain scan's
    n, nq, k = 20_000, 96, 10
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    data = torch.from_numpy(rng.integers(lo, hi, (n, d)).astype(np.int16)).to(dtype)
    q = data[rng.choice(n, nq, replace=False)].to(torch.float32)
    q = q + torch.from_numpy(8 * rng.standard_normal((nq, d)).astype(np.float32))
    before = dict(scan_buckets.variants)
    gd, gi = fused_knn(data.to(cuda), q.to(cuda), k, metric)
    after = dict(scan_buckets.variants)
    assert {v: after[v] - before[v] for v in after if after[v] != before[v]}.keys() == {"wgmma_mixed"}
    cd, ci = fused_knn(data, q, k, metric)
    same = gi.cpu() == ci
    assert float(same.float().mean()) >= 0.99
    torch.testing.assert_close(gd.cpu()[same], cd[same], rtol=1e-5, atol=1e-5)


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


def _clustered(n, d, nq, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    data = centers[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    queries = data[rng.choice(n, nq, replace=False)] + 0.05 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    return data.astype(np.float32), queries.astype(np.float32)


def _quantizers(nbits, data, cuda):
    """One codebook, trained on the CPU, on both devices."""
    cpu = ProductQuantizer(dim=32, num_subquantizers=8, nbits=nbits, device="cpu").train(
        data[:1000], n_iters=8)
    card = ProductQuantizer(dim=32, num_subquantizers=8, nbits=nbits, device=cuda)
    card.codebook = PQCodebook(cpu.codebook.centroids.to(cuda))
    return cpu, card


def test_pq_train_on_card_matches_cpu(cuda):
    # Lloyd's steps drift, so the quantizers are held by reconstruction
    # error: within 2%; codes from one codebook identical in >= 99.9%
    data, _ = _clustered(3000, 32, 8)
    cpu, card = _quantizers(8, data, cuda)
    trained = ProductQuantizer(dim=32, num_subquantizers=8).train(data[:1000], n_iters=8)
    assert trained.device.type == "cuda" and trained.codebook.centroids.is_cuda
    mse = lambda q: float(((q.decode(q.encode(data)).cpu().numpy() - data) ** 2).sum(1).mean())
    assert abs(mse(trained) - mse(cpu)) <= 0.02 * mse(cpu)
    assert (card.encode(data).cpu() == cpu.encode(data)).float().mean() >= 0.999
    np.testing.assert_allclose(card.adc_tables(data[:8]).cpu().numpy(),
                               cpu.adc_tables(data[:8]).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["adc", "raw", "packed_4bit", "lane_packed", "n_valid"])
def test_pq_scan_on_card_matches_cpu(cuda, mode):
    # the card's bf16 product with float32 output against the CPU's float32
    # matmul of the same rounded operands: ids equal in >= 99% of slots
    # (exact ties of the ADC rerank exempt), distances allclose(rtol=1e-4)
    n = 3000 if mode != "lane_packed" else 2917
    data, queries = _clustered(n, 32, 32)
    cpu, card = _quantizers(4 if mode == "packed_4bit" else 8, data, cuda)
    codes = cpu.encode(data)
    tables = cpu.adc_tables(queries)
    kw = dict(tile_size=512, rerank=64)
    if mode == "packed_4bit":
        codes, kw["packed_4bit"] = pack_codes_4bit(codes), True
    if mode == "lane_packed":
        codes = torch.from_numpy(pack_codes_lanes(codes.numpy(), tile=512)[0])
        kw.update(lane_packed=True, n_valid=n)
    if mode == "n_valid":
        kw["n_valid"] = 700
    raw = {}
    if mode == "raw":
        raw = dict(vectors=torch.from_numpy(data), queries=torch.from_numpy(queries))
    launches = gather_distances.launches
    cd, ci = pq_scan_knn(codes, tables, 10, **kw, **raw)
    gd, gi = pq_scan_knn(codes.to(cuda), tables.to(cuda), 10, **kw,
                         **{k: v.to(cuda) for k, v in raw.items()})
    assert gd.is_cuda and gather_distances.launches == launches + (mode == "raw")
    gd, gi = gd.cpu(), gi.cpu()
    np.testing.assert_allclose(gd.numpy(), cd.numpy(), rtol=1e-4, atol=1e-5)
    tied = torch.zeros_like(ci, dtype=torch.bool)
    tied[:, 1:] |= cd[:, 1:] == cd[:, :-1]
    tied[:, :-1] |= cd[:, :-1] == cd[:, 1:]
    tied[:, -1] |= mode != "raw"  # the last slot may tie with the one cut off
    assert float(((gi == ci) | tied).float().mean()) >= 0.99
    assert int(gi.max()) < kw.get("n_valid", n)


def test_pq_index_on_card_matches_cpu(cuda, tmp_path):
    data, queries = _clustered(3000, 32, 128)
    cpu, card = _quantizers(8, data, cuda)
    ix = PQIndex(cpu, dataset_size=3000, max_edges_per_node=16)
    ix.add(data, ef_construction=64)
    path = str(tmp_path / "pq.idx")
    ix.save(path)
    on_card = PQIndex.load(path)  # the card is the default
    assert on_card.device.type == "cuda" and on_card._codes.is_cuda
    # the same graph searched on both devices: ids equal in >= 99% of rows
    cd, cl = ix.search(queries, K=10, ef_search=96)
    gd, gl = on_card.search(queries, K=10, ef_search=96)
    same = (cl == gl).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gd[same], cd[same], rtol=1e-4, atol=1e-5)
    sd, sl = ix.search_scan(queries, K=10, rerank=64, tile_size=512)
    td, tl = on_card.search_scan(queries, K=10, rerank=64, tile_size=512)
    np.testing.assert_allclose(td, sd, rtol=1e-4, atol=1e-5)
    # built on the card from the same codebook: recall@10 within 0.02
    built = PQIndex(card, dataset_size=3000, max_edges_per_node=16)
    built.add(data, ef_construction=64)
    assert built.num_nodes == 3000 and built._links.is_cuda
    _, gt = brute_force_knn(torch.from_numpy(data), torch.from_numpy(queries), 10)
    recall = lambda l: sum(len(set(a.tolist()) & set(b.tolist()))
                           for a, b in zip(l, gt.numpy())) / gt.numel()
    _, bl = built.search(queries, K=10, ef_search=96)
    assert abs(recall(bl) - recall(cl)) <= 0.02


def test_reorder_and_import_on_card_match_cpu(cuda, tmp_path):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2000, 32), dtype=np.float32)
    q = rng.standard_normal((64, 32), dtype=np.float32)
    cpu_ix = flatnav_tpu_torch.index.create("l2", 32, 2000, 16, device="cpu")
    cpu_ix.add(data, ef_construction=64)
    path = str(tmp_path / "g.npz")
    cpu_ix.save(path)
    card_ix = flatnav_tpu_torch.index.load_index(path)
    assert card_ix.device.type == "cuda"
    for ix in (cpu_ix, card_ix):
        ix.reorder(["gorder", "rcm"])
    # the relabel runs on each index's device and gives the same committed
    # rows (past them a built index keeps its last wave's padding lanes, a
    # loaded one zeros)
    for a, b in zip((cpu_ix.graph.vectors, cpu_ix.graph.links, cpu_ix.graph.labels),
                    (card_ix.graph.vectors, card_ix.graph.links, card_ix.graph.labels)):
        assert torch.equal(a[:2000], b[:2000].cpu())
    launches = gather_distances.launches
    gd, gl = card_ix.search(q, K=10, ef_search=64)
    assert gather_distances.launches > launches  # the reordered search runs K2
    cd, cl = cpu_ix.search(q, K=10, ef_search=64)
    assert (gl == cl).all(axis=1).mean() >= 0.99
    # MatrixMarket import on the card
    links = card_ix.graph.links[:2000].cpu().numpy()
    mtx = tmp_path / "g.mtx"
    with open(mtx, "w") as f:
        edges = [(i, v) for i, row in enumerate(links) for v in row if v != i]
        f.write(f"%%MatrixMarket matrix coordinate pattern general\n2000 2000 {len(edges)}\n")
        f.writelines(f"{a + 1} {b + 1}\n" for a, b in edges)
    fresh = flatnav_tpu_torch.index.create("l2", 32, 2000, 16)
    fresh.allocate_nodes(card_ix.graph.vectors[:2000].cpu().numpy(),
                         card_ix.graph.labels[:2000].cpu().numpy())
    fresh.build_graph_links(str(mtx))
    assert torch.equal(fresh.graph.links, card_ix.graph.links)
    fd, fl = fresh.search(q, K=10, ef_search=64)
    np.testing.assert_array_equal(fl, gl)
    np.testing.assert_array_equal(fd, gd)


# ---------------------------------------------------------------------------
# the search options, the harness, the headline entry and the routed scan
# ---------------------------------------------------------------------------


def _small_index(device, n=3000, d=32, m=16, nq=128):
    rng = np.random.default_rng(9)
    data = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((nq, d), dtype=np.float32)
    ix = flatnav_tpu_torch.index.create("l2", d, n, m, device=device)
    ix.add(data, ef_construction=64)
    return ix, data, q


@pytest.mark.parametrize("cw", [24, 32, 100])
def test_gather_distances_at_compact_width(cuda, cw, monkeypatch):
    # K2 is launched at C = compact_width and is bit-equal to its plain
    # version there; the search agrees with the same search on the CPU
    from flatnav_tpu_torch.index import search as search_mod
    from flatnav_tpu_torch.index.search import batched_search

    ix, _, q = _small_index("cpu")
    g = ix.graph
    calls = []

    def spy(vectors, ids, queries, metric):
        got = gather_distances(vectors, ids, queries, metric)
        calls.append(ids.shape[1])
        assert torch.equal(got, gather_distances_plain(vectors, ids, queries, metric))
        return got

    monkeypatch.setattr(search_mod, "gather_distances", spy)
    kw = dict(k=10, ef=32, expand_factor=8, compact_width=cw, m_search=12)
    before = gather_distances.launches
    card = batched_search(g.vectors.cuda(), g.links.cuda(), g.labels.cuda(), g.num_nodes,
                          torch.from_numpy(q).cuda(), **kw)
    assert set(calls) == {min(cw, 8 * 12)} and gather_distances.launches == before + len(calls)
    monkeypatch.undo()
    cpu = batched_search(g.vectors, g.links, g.labels, g.num_nodes, torch.from_numpy(q), **kw)
    same = (card.labels.cpu() == cpu.labels).all(dim=1)
    assert float(same.float().mean()) >= 0.99
    assert torch.allclose(card.dists.cpu()[same], cpu.dists[same], rtol=1e-5)


def test_m_search_view_gathers_without_a_table_copy(cuda):
    links = torch.arange(2_000_000 * 32, dtype=torch.int32, device=cuda).view(-1, 32)
    rows = torch.randint(0, links.shape[0], (4096,), device=cuda)
    view = links[:, :16]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = view[rows]
    torch.cuda.synchronize()
    # the gather allocates its [4096, 16] result, not a copy of the 128 MB view
    assert torch.cuda.max_memory_allocated() - base < 4 * 1024 * 1024
    assert torch.equal(got, links[rows][:, :16])


def test_graph_entry_points_land_on_the_card(cuda, tmp_path):
    from flatnav_tpu_torch.index import graph as graph_mod
    from flatnav_tpu_torch.index import serialize

    g = graph_mod.make_empty_graph(10, 8, 4)
    assert g.vectors.is_cuda and g.links.is_cuda
    g = graph_mod.graph_from_numpy(np.ones((5, 8), np.float32),
                                   np.zeros((5, 4), np.int32))
    assert g.vectors.is_cuda
    path = str(tmp_path / "g.npz")
    serialize.save_index(path, g, MetricType.L2)
    assert serialize.load_index(path)[0].vectors.is_cuda


@pytest.mark.parametrize("index_type,min_recall", [
    ("flatnav", 0.9), ("flatnav-fused", 0.98), ("flatnav-fusednr", 0.95),
    ("flatnav-exact", 1.0), ("flatnav-fast", 0.98), ("flatnav-pq-scan", 0.9),
])
def test_harness_on_card(cuda, tmp_path, index_type, min_recall):
    from flatnav_tpu_torch.bench import run_benchmark

    rng = np.random.default_rng(1)
    train = rng.standard_normal((3000, 32)).astype(np.float32)
    queries = rng.standard_normal((100, 32)).astype(np.float32)
    _, gt = brute_force_knn(torch.from_numpy(train), torch.from_numpy(queries), 10)
    for name, arr in (("train", train), ("queries", queries), ("gt", gt.numpy())):
        np.save(tmp_path / f"{name}.npy", arr)
    k1, k2 = scan_buckets.launches, gather_distances.launches
    rows = run_benchmark.main([
        "--dataset", str(tmp_path / "train.npy"), "--queries", str(tmp_path / "queries.npy"),
        "--gtruth", str(tmp_path / "gt.npy"), "--index-type", index_type,
        "--num-node-links", "16", "--ef-construction", "64", "--ef-search", "96",
        "--k", "10", "--batch-size", "64", "--no-plot",
        "--metrics-file", str(tmp_path / "metrics.json")])
    assert len(rows) == 1 and rows[0]["recall"] >= min_recall and rows[0]["qps"] > 0
    if index_type.startswith("flatnav-fused"):
        assert scan_buckets.launches > k1
    if index_type in ("flatnav", "flatnav-pq-scan"):
        assert gather_distances.launches > k2


def test_headline_on_card(cuda, tmp_path, capsys):
    import json

    from flatnav_tpu_torch.bench import headline

    files = ["--index", str(tmp_path / "ix.npz"), "--queries-file", str(tmp_path / "q.npy")]
    headline.main(["--n", "5000", "--dim", "64", "--num-queries", "512", "--batch", "512",
                   "--m", "16", *files])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["exact_recall"] == 1.0 and out["recall"] >= 0.95 and out["value"] > 0
    assert "NVIDIA" in out["device"] and out["vs_baseline"] is None
    assert out["kernel_launches"]["scan_buckets"] > 0
    assert out["kernel_launches"]["gather_distances"] > 0
    headline.main(["--time-only", "--engine", "graph", "--ef-search", "64", "--m-search", "8",
                   "--compact-width", "128", "--batch", "512", *files])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["qps"] > 0


def test_routed_scan_on_card_matches_cpu(cuda):
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.ops import build_routed_scan, routed_knn
    from flatnav_tpu_torch.ops.routed_scan import RoutedScan

    data, queries = clustered(4000, 32, 100, center_scale=4.0, query_noise=0.5)
    rs = build_routed_scan(data, block=256)  # the card is the default
    assert rs.vectors.is_cuda and rs.ids.is_cuda
    q = torch.from_numpy(queries).cuda()
    _, gt = brute_force_knn(torch.from_numpy(data).cuda(), q, 5)
    nb = rs.block_centroids.shape[0]
    _, full = routed_knn(rs, q, 5, union_blocks=nb, group_size=32)
    assert torch.equal(full.sort(dim=1).values, gt.sort(dim=1).values)
    # the same layout searched on both devices
    on_cpu = RoutedScan(rs.vectors.cpu(), rs.ids.cpu(), rs.block_centroids.cpu(),
                        rs.n, rs.block, rs.metric)
    kw = dict(probes=4, union_blocks=nb // 3, group_size=32)
    gd, gi = routed_knn(rs, q, 5, **kw)
    cd, ci = routed_knn(on_cpu, q.cpu(), 5, **kw)
    assert float((gi.cpu() == ci).float().mean()) >= 0.99
    assert torch.allclose(gd.cpu(), cd, rtol=1e-4, atol=1e-4)
    again = routed_knn(rs, q, 5, **kw)
    assert torch.equal(again[0], gd) and torch.equal(again[1], gi)


@pytest.mark.parametrize("backend,shape", [("nccl", (1, 1)), ("gloo", (1, 2)), ("gloo", (2, 1))])
def test_sharded_paths_on_card_equal_single_device(cuda, backend, shape):
    # NCCL takes one card a rank; two gloo ranks share card 0. The sharded
    # search, fused scan and mesh build equal the single-device port's, and
    # every rank launches K2 in the search and K1 in the fused scan
    from flatnav_tpu_torch.data_type import to_numpy
    from flatnav_tpu_torch.index.build import add_batch
    from flatnav_tpu_torch.index.graph import make_empty_graph
    from flatnav_tpu_torch.index.search import batched_search
    from flatnav_tpu_torch.ops import fused_knn
    from flatnav_tpu_torch.parallel import run_ranks
    from flatnav_tpu_torch.parallel.dryrun import run_cases
    from flatnav_tpu_torch.parallel.sharded_exact import shards_on_one_device

    data, q = _clustered(6000, 64, 256)
    g = add_batch(make_empty_graph(6000, 64, 16), data, np.arange(6000), ef_construction=64,
                  metric=MetricType.L2)
    graph = {"vectors": to_numpy(g.vectors), "links": to_numpy(g.links), "labels": to_numpy(g.labels),
             "num_nodes": g.num_nodes, "capacity": g.capacity}
    build = {"data": data[:2000], "capacity": 2000, "max_edges": 16, "ef_construction": 64,
             "metric": MetricType.L2}
    spec = "model" if shape[1] > 1 else "replicated"
    cases = [
        {"op": "search", "args": {"graph": graph, "queries": q, "k": 10, "ef": 64, "expand_factor": 4}},
        {"op": "exact", "args": {"vectors": data, "num_nodes": 6000, "queries": q, "k": 10, "rerank": 32,
                                 "fused": True}},
        {"op": "build", "args": {**build, "table_spec": spec}},
    ]
    search, fused, built = run_ranks(run_cases, shape[0] * shape[1], backend=backend, device="cuda",
                                     timeout=600, args=(cases, *shape, "cuda"))
    qd = torch.from_numpy(q).to(cuda)
    want = batched_search(g.vectors, g.links, g.labels, g.num_nodes, qd, k=10, ef=64, expand_factor=4)
    assert np.array_equal(search["labels"], want.labels.cpu().numpy())
    np.testing.assert_allclose(search["dists"], want.dists.cpu().numpy(), rtol=0, atol=1e-5)
    _, ids = shards_on_one_device(lambda r, nv: fused_knn(r, qd, 10, rerank=32, n_valid=nv),
                                  torch.from_numpy(data).to(cuda), 6000, shape[1], 10)
    assert np.array_equal(fused["ids"], ids.cpu().numpy())
    ref = add_batch(make_empty_graph(2000, 64, 16), data[:2000], np.arange(2000), ef_construction=64,
                    metric=MetricType.L2)
    assert np.array_equal(built["links"], to_numpy(ref.links)[: built["links"].shape[0]])
    assert (search["launches"][:, 1] > 0).all() and (fused["launches"][:, 0] > 0).all()


def test_fast_knn_ranks_by_bf16_keys_on_card(cuda, rng):
    # fast_knn's phase 1 takes the TPU's DEFAULT-precision form: one bf16
    # product with a float32 result; its rerank stays exact
    from flatnav_tpu_torch.ops.distances import bf16_dot, fast_knn

    data = torch.tensor([[1.002], [0.997]], device=cuda)
    q = torch.tensor([[1.0]], device=cuda)
    dist, ids = fast_knn(data, q, 1, MetricType.L2, rerank=1)
    assert ids.tolist() == [[1]]  # row 0 is nearer, but its bf16 key is larger
    assert abs(dist.item() - float((data[1] - q[0]).pow(2).sum())) == 0.0

    x = rng.standard_normal((64, 96), dtype=np.float32)
    y = rng.standard_normal((5000, 96), dtype=np.float32)
    xr, yr = (torch.from_numpy(a).to(torch.bfloat16).double() for a in (x, y))
    keys = bf16_dot(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda))
    assert keys.dtype == torch.float32
    np.testing.assert_allclose(keys.cpu().numpy(), (xr @ yr.T).numpy(), rtol=1e-5, atol=1e-4)

    # the card's keys rank as the CPU's rounded-operand keys do
    gd, gi = fast_knn(torch.from_numpy(y).to(cuda), torch.from_numpy(x).to(cuda), 10, tile_size=1024)
    cd, ci = fast_knn(torch.from_numpy(y), torch.from_numpy(x), 10, tile_size=1024)
    same = gi.cpu().numpy() == ci.numpy()
    assert same.mean() >= 0.99
    np.testing.assert_allclose(gd.cpu().numpy()[same], cd.numpy()[same], rtol=1e-5, atol=1e-5)


# ---- K3 (csrc/select_k.cu): bit-equal to select_k_plain, keys by their bits

K3_SPECIAL = [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0]


def _k3_keys(rng, kind, b, w, device):
    if kind == "normal":
        x = rng.standard_normal((b, w)).astype(np.float32)
        at = rng.integers(0, b * w, max(1, b * w // 50))
        x.reshape(-1)[at] = np.array(K3_SPECIAL, np.float32)[rng.integers(0, 7, len(at))]
        x.reshape(-1)[at[::3]] = -np.float32(np.nan)  # NaN with the sign bit set
    elif kind == "ties":  # 8-bit tables: integer keys, thousands of exact ties
        x = rng.integers(0, 16, (b, w)).astype(np.float32)
    elif kind == "descending":  # every word passes the filter
        x = -np.sort(rng.standard_normal((b, w)).astype(np.float32), axis=1)
    else:  # whole rows of +inf: ordered by id alone
        x = np.full((b, w), np.inf, np.float32)
    return torch.from_numpy(x).to(device)


def _k3_equal(got, want):
    return (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1]))


@pytest.mark.parametrize("ids_kind", ["full", "row", "implicit"])
@pytest.mark.parametrize("kind", ["normal", "ties", "descending", "inf"])
@pytest.mark.parametrize("b,w,k", [(1, 7, 7), (37, 7, 1), (64, 3000, 10), (8, 20000, 32),
                                   (1, 131072, 64), (300, 8192, 64), (4, 50000, 1024),
                                   (2, 9000, "K_MAX"), (4096, 64, 32)])
def test_select_k_bit_equal(cuda, rng, b, w, k, kind, ids_kind):
    from flatnav_tpu_torch.ops.select_k import K_MAX, select_k, select_k_plain

    k = K_MAX if k == "K_MAX" else k
    keys = _k3_keys(rng, kind, b, w, cuda)
    kw = {"id_base": 777, "cols": (w // 10, w - w // 9)} if ids_kind == "implicit" else {}
    if ids_kind == "full":
        kw["ids"] = torch.from_numpy(rng.integers(0, 1 << 31, (b, w)).astype(np.int32)).to(cuda)
    elif ids_kind == "row":
        kw["ids"] = torch.from_numpy(rng.integers(0, 50, (1, w)).astype(np.int32)).to(cuda)
    before = select_k.launches
    got = select_k(keys, k, **kw)
    assert select_k.launches > before
    assert _k3_equal(got, select_k_plain(keys, k, **kw))


def test_select_k_repeated_pairs(cuda, rng):
    # equal keys with repeated ids: the same (key, id) pair many times
    from flatnav_tpu_torch.ops.select_k import select_k, select_k_plain

    keys = torch.from_numpy(rng.integers(0, 3, (50, 40000)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, 30, (50, 40000)).astype(np.int32)).to(cuda)
    for k in (5, 100, 2000):
        assert _k3_equal(select_k(keys, k, ids=ids), select_k_plain(keys, k, ids=ids))


def test_select_k_refuses_on_the_card(cuda):
    from flatnav_tpu_torch.ops.select_k import select_k

    keys = torch.zeros((4, 100), device=cuda)
    with pytest.raises(ValueError):
        select_k(keys.t(), 5)  # not contiguous
    with pytest.raises(ValueError):
        select_k(keys, 5, ids=torch.zeros((4, 100), dtype=torch.int32))  # ids on the CPU
    with pytest.raises(TypeError):
        select_k(keys.half(), 5)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_scans_select_through_k3_on_card(cuda, rng, dtype):
    # brute_force_knn, fast_knn, pq_scan_knn and fused_knn launch K3; on an
    # 8-bit table the exact scan's distances are exact integers, so the
    # card's result equals the CPU's bit for bit, ties included
    from flatnav_tpu_torch.ops.distances import fast_knn
    from flatnav_tpu_torch.ops.select_k import select_k

    if dtype == np.uint8:
        data = rng.integers(0, 4, (5000, 16)).astype(np.uint8)
        q = rng.integers(0, 4, (64, 16)).astype(np.uint8)
    else:
        data = rng.standard_normal((5000, 16)).astype(np.float32)
        q = rng.standard_normal((64, 16)).astype(np.float32)
    dg, qg = torch.from_numpy(data).to(cuda), torch.from_numpy(q).to(cuda)
    for name, call in (("brute", lambda d, x: brute_force_knn(d, x, 10, tile_size=1024, n_valid=4700)),
                       ("fast", lambda d, x: fast_knn(d, x, 10, tile_size=1024, rerank=40)),
                       ("fused", lambda d, x: fused_knn(d, x, 10, rerank=32))):
        before = select_k.launches
        gd, gi = call(dg, qg)
        assert select_k.launches > before, name
        if dtype == np.uint8 and name != "fused":
            cd, ci = call(torch.from_numpy(data), torch.from_numpy(q))
            assert torch.equal(gi.cpu(), ci) and torch.equal(gd.cpu(), cd), name
    codes = torch.from_numpy(rng.integers(0, 16, (5000, 4)).astype(np.uint8))
    tables = torch.from_numpy(rng.integers(0, 6, (64, 4, 16)).astype(np.float32))
    before = select_k.launches
    gd, gi = pq_scan_knn(codes.to(cuda), tables.to(cuda), 10, tile_size=1024, rerank=64)
    assert select_k.launches > before
    cd, ci = pq_scan_knn(codes, tables, 10, tile_size=1024, rerank=64)
    assert torch.equal(gd.cpu(), cd)  # ADC sums of small integers are exact


# ---- K3's routes: bulk copies (block), a warp a row, the prior


def _k3_check(keys, k, **kw):
    from flatnav_tpu_torch.ops.select_k import select_k, select_k_plain

    before = select_k.launches
    got = select_k(keys, k, **kw)
    assert select_k.launches > before
    assert _k3_equal(got, select_k_plain(keys, k, **kw))


def _at_offset(x, off):
    """x [B, W] copied into a flat buffer at `off` floats: contiguous, with
    data_ptr() % 16 == 4 * off"""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    y = flat[off : off + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 4 * off
    return y


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("w", [8197, 20001, 131071])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_select_k_block_route_unaligned_rows(cuda, rng, off, w, kind):
    # W % 4 != 0: every row but the first starts off a 16-byte boundary, and
    # the tensor itself starts at 4 * off bytes past one
    from flatnav_tpu_torch.ops.select_k import _route

    b = 24
    keys = _at_offset(_k3_keys(rng, kind, b, w, cuda), off)
    for k in (10, 100):
        assert _route(k, w) == "block"
        _k3_check(keys, k, id_base=5, cols=(3, w - 2))
        _k3_check(keys, k, ids=_at_offset(torch.from_numpy(
            rng.integers(0, 1 << 31, (b, w)).astype(np.int32)).to(cuda), (off + 1) % 4))


@pytest.mark.parametrize("w", [7, 196, 8191, 8192, 8193])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 63, 64, 65])
def test_select_k_warp_route_thresholds(cuda, rng, w, k):
    from flatnav_tpu_torch.ops.select_k import WARP_K, WARP_MAX_W, _route

    k = min(k, w)
    assert (_route(k, w) == "warp") == (k <= WARP_K and w <= WARP_MAX_W)
    for kind in ("normal", "ties", "inf"):
        keys = _at_offset(_k3_keys(rng, kind, 37, w, cuda), w % 4)
        _k3_check(keys, k, ids=torch.from_numpy(
            rng.integers(0, 60, (1, w)).astype(np.int32)).to(cuda))
        _k3_check(keys, k, id_base=11, cols=(w // 5, w - w // 6))


def _prior(rng, b, r, cuda, kind):
    """a running shortlist [b, r]: sorted finite pairs, the (+inf, id 0)
    padding a scan starts from, or a mix of the two"""
    d = np.sort(rng.standard_normal((b, r)).astype(np.float32), axis=1)
    i = rng.integers(0, 1 << 20, (b, r)).astype(np.int32)
    if kind == "pad":
        d[:], i[:] = np.inf, 0
    elif kind == "mixed":
        d[:, r // 2 :], i[:, r // 2 :] = np.inf, 0
    return torch.from_numpy(d).to(cuda), torch.from_numpy(i).to(cuda)


@pytest.mark.parametrize("b,w,r", [(4096, 64, 32), (16384, 196, 8), (300, 8192, 64),
                                   (64, 65536, 10), (200, 32768, 64), (16, 131072, 32),
                                   (1, 131072, 32), (3, 100, 150), (8, 20000, 1024),
                                   (2, 9000, "K_MAX"), (1, 390656, 1024)])
@pytest.mark.parametrize("kind", ["pad", "mixed", "finite"])
def test_select_k_prior_seeded(cuda, rng, b, w, r, kind):
    from flatnav_tpu_torch.ops.select_k import K_MAX

    r = K_MAX if r == "K_MAX" else r
    keys = _k3_keys(rng, "normal", b, w, cuda)
    prior = _prior(rng, b, r, cuda, kind)
    _k3_check(keys, r, id_base=0, cols=(w // 9, w - w // 8), prior=prior)
    # integer keys with thousands of ties, the prior's pairs repeated in the tile
    keys = _k3_keys(rng, "ties", b, w, cuda)
    pd = keys[:, : min(r, w)].clone()
    pi = torch.arange(min(r, w), dtype=torch.int32, device=cuda).expand(b, -1).contiguous()
    if r > w:
        pd = torch.cat([pd, torch.full((b, r - w), float("inf"), device=cuda)], 1)
        pi = torch.cat([pi, torch.zeros((b, r - w), dtype=torch.int32, device=cuda)], 1)
    _k3_check(keys, r, prior=(pd.contiguous(), pi.contiguous()))


def _merge_tile_two_launch(best_d, best_i, keys, start, cols):
    """The parent's `_merge_tile`: the tile's r smallest, then the r
    smallest of the 2r."""
    from flatnav_tpu_torch.ops.select_k import select_k

    r = best_d.shape[1]
    tile_d, tile_i = select_k(keys, min(r, keys.shape[1]), id_base=start, cols=cols)
    return select_k(torch.cat([best_d, tile_d], 1), r, ids=torch.cat([best_i, tile_i], 1))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_scans_equal_the_two_launch_merge_on_card(cuda, rng, dtype, monkeypatch):
    from flatnav_tpu_torch.ops import distances as dist_mod
    from flatnav_tpu_torch.ops.distances import fast_knn
    from flatnav_tpu_torch.ops.select_k import select_k
    from flatnav_tpu_torch.quantization import pq as pq_mod

    if dtype == np.uint8:
        data = torch.from_numpy(rng.integers(0, 4, (20000, 16)).astype(np.uint8)).to(cuda)
        q = torch.from_numpy(rng.integers(0, 4, (300, 16)).astype(np.uint8)).to(cuda)
    else:
        data = torch.from_numpy(rng.standard_normal((20000, 16)).astype(np.float32)).to(cuda)
        q = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32)).to(cuda)
    codes = torch.from_numpy(rng.integers(0, 16, (20000, 4)).astype(np.uint8)).to(cuda)
    tables = torch.from_numpy(rng.integers(0, 6, (300, 4, 16)).astype(np.float32)).to(cuda)
    calls = {
        "brute": lambda: dist_mod.brute_force_knn(data, q, 10, tile_size=4096, n_valid=19000),
        "fast": lambda: fast_knn(data, q, 10, tile_size=4096, rerank=40),
        "pq": lambda: pq_mod.pq_scan_knn(codes, tables, 10, tile_size=4096, rerank=100),
    }
    new, launches = {}, {}
    for name, call in calls.items():
        before = select_k.launches
        new[name] = call()
        launches[name] = select_k.launches - before
    monkeypatch.setattr(dist_mod, "_merge_tile", _merge_tile_two_launch)
    monkeypatch.setattr(pq_mod, "_merge_tile", _merge_tile_two_launch)
    for name, call in calls.items():
        before = select_k.launches
        old = call()
        assert select_k.launches - before == 2 * launches[name], name  # one launch a tile now
        assert _k3_equal(new[name], old), name


# ---------------------------------------------------------------------------
# the hop's bookkeeping (csrc/beam_hop.cu) against its PyTorch chain
# ---------------------------------------------------------------------------


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cw", [0, 5], ids=["uncompacted", "compacted"])
@pytest.mark.parametrize("e_f", [1, 4])
@pytest.mark.parametrize("kind", ["ties", "dups", "out_of_range", "signed_zero"])
def test_beam_hop_kernels_equal_their_stages_every_hop(cuda, kind, e_f, cw):
    import beam_hop_cases as cases

    links, table = (torch.from_numpy(a).to(cuda) for a in cases.make(kind))
    score, entry = cases.torch_blocks(table)
    hops, _ = hop_lockstep(links, score, entry, cases.N, cases.B, ef=8, e_f=e_f, cw=cw)
    assert hops > 1


@pytest.mark.parametrize("ef,c", [(16, 40), (16, 8), (512, 2048), (192, 512)])
def test_beam_hop_merge_orders_as_torch_sort(cuda, ef, c):
    # beams out of order, NaN in the beam and among the new distances,
    # -0.0 beside +0.0, +inf, rows with nothing fresh (in order and not)
    from flatnav_tpu_torch.index import search as S
    from flatnav_tpu_torch.ops.beam_hop import BeamHop

    g = torch.Generator(device=cuda).manual_seed(ef + c)
    vals = torch.tensor([-0.0, 0.0, 0.5, 1.0, float("inf"), float("nan")], device=cuda)
    b = 64

    def draw(shape):
        return vals[torch.randint(0, len(vals), shape, device=cuda, generator=g)]

    beam_d = draw((b, ef))
    beam_d[: b // 4] = beam_d[: b // 4].sort(dim=1).values  # in order, NaN last
    beam_d[b // 8 : b // 4] = torch.where(beam_d[b // 8 : b // 4].isnan(), float("inf"),
                                          beam_d[b // 8 : b // 4])
    beam_i = torch.randint(0, 1000, (b, ef), device=cuda, generator=g, dtype=torch.int32)
    beam_e = torch.rand((b, ef), device=cuda, generator=g) < 0.5
    s = draw((b, c))
    nbrs = torch.randint(-1, 1000, (b, c), device=cuda, generator=g, dtype=torch.int32)
    fresh = torch.rand((b, c), device=cuda, generator=g) < 0.3
    fresh[: b // 2 : 2] = False  # nothing fresh
    want = S._merge((beam_d, beam_i, beam_e), nbrs, fresh, torch.where(fresh, s, float("inf")), ef)
    dcomp = torch.zeros((), dtype=torch.int64, device=cuda)
    hist = torch.full((b, c), -1, dtype=torch.int32, device=cuda)
    # a hop of c candidates: one expansion of c links
    hop = BeamHop(beam_d, beam_i, beam_e, hist, dcomp, dcomp.clone(), e_f=1, m=c)
    hop.fresh.copy_(fresh)
    hop.merge(s, nbrs, 7)
    assert _same_bits(beam_d, want[0]) and torch.equal(beam_i, want[1])
    assert torch.equal(beam_e, want[2])
    assert int(dcomp) == int(fresh.sum())
    assert int(hop.flag) == (7 if bool((~want[2]).any()) else 0)


def _clustered_graph(cuda, n, d, m, b, seed=3):
    """A random m-link graph over a clustered table (the search's data, not
    its graph: every hop still revisits, dedups and merges)."""
    from flatnav_tpu_torch.bench.synth import clustered

    data, q = clustered(n, d, b, seed=seed, centers_per_64k=26)
    vectors = torch.from_numpy(data).to(cuda)
    queries = torch.from_numpy(q).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    links = torch.randint(0, n, (n, m), device=cuda, generator=g, dtype=torch.int32)
    return vectors, queries, links


@pytest.mark.parametrize("d,ef,e_f,cw", [(128, 512, 64, 0), (960, 192, 16, 0), (128, 100, 16, 300),
                                         (32, 1024, 128, 0)],
                         ids=["sift_cell", "gist_cell", "wave_compacted", "plan_edge"])
def test_beam_hop_kernels_equal_their_stages_at_the_cells_shapes(cuda, d, ef, e_f, cw):
    from flatnav_tpu_torch.index.search import table_blocks

    vectors, queries, links = _clustered_graph(cuda, 100_000, d, 32, 1000)
    score, entry = table_blocks(vectors, queries, MetricType.L2)
    hops, hop = hop_lockstep(links, score, entry, 100_000, 1000, ef=ef, e_f=e_f, cw=cw)
    assert hops > 4 and hop.workspace is None  # shared memory holds the cells' rows


def _chain_only(monkeypatch):
    from flatnav_tpu_torch.ops import beam_hop

    monkeypatch.setattr(beam_hop, "engages", lambda *args: False)


@pytest.mark.parametrize("d,ef,e_f", [(128, 512, 64), (960, 192, 16)], ids=["sift", "gist"])
def test_batched_search_routes_agree(cuda, monkeypatch, d, ef, e_f):
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.index.search import batched_search
    from flatnav_tpu_torch.utils import profiling

    data, q = clustered(100_000, d, 1000, seed=5, centers_per_64k=26)
    ix = flatnav_tpu_torch.index.create("l2", d, 100_000, 32)
    ix.add(data, ef_construction=100)
    g = ix.graph
    queries = torch.from_numpy(q).to(cuda)
    kw = dict(k=10, ef=ef, expand_factor=e_f)
    profiling.snapshot(reset=True)
    with profiling.tracing():
        fused = batched_search(g.vectors, g.links, g.labels, g.num_nodes, queries, **kw)
    snap = profiling.snapshot(reset=True)
    hop_calls = sum(r["calls"] for p, r in snap["spans"].items() if p.endswith("search.hop"))
    assert hop_calls > 4 and snap["counters"]["search.hops_fused"] == hop_calls
    _chain_only(monkeypatch)
    with profiling.tracing():
        chain = batched_search(g.vectors, g.links, g.labels, g.num_nodes, queries, **kw)
    assert "search.hops_fused" not in profiling.snapshot(reset=True)["counters"]
    assert _same_bits(fused.dists, chain.dists) and torch.equal(fused.labels, chain.labels)
    assert (fused.dist_computations, fused.hops) == (chain.dist_computations, chain.hops)


def test_index_add_builds_the_same_links_by_both_routes(cuda, monkeypatch):
    from flatnav_tpu_torch.bench.synth import clustered
    from flatnav_tpu_torch.ops.beam_hop import BeamHop

    data, _ = clustered(20_000, 64, 8, seed=7, centers_per_64k=26)
    launches = BeamHop.launches
    fused = flatnav_tpu_torch.index.create("l2", 64, 20_000, 16)
    fused.add(data, ef_construction=100)
    assert BeamHop.launches > launches  # the wave search ran the kernels
    _chain_only(monkeypatch)
    chain = flatnav_tpu_torch.index.create("l2", 64, 20_000, 16)
    chain.add(data, ef_construction=100)
    assert torch.equal(fused.graph.links, chain.graph.links)


@pytest.mark.parametrize("opts,spills", [
    (dict(ef=1100), False),
    (dict(max_hops=400), False),
    (dict(max_hops=1200), True),  # membership's sets in the workspace
    (dict(ef=12_000, expand_factor=16), True),  # membership's and the merge's
], ids=["ef", "history", "history_in_workspace", "ef_in_workspace"])
def test_shapes_past_the_plan_run_the_kernels_equal_to_the_chain(cuda, monkeypatch, opts, spills):
    # wide beams and long histories: every stage at every hop, and the whole
    # search, equal to the chain; a row too large for shared memory runs on
    # the global-memory workspace
    from flatnav_tpu_torch.index.search import batched_search, table_blocks
    from flatnav_tpu_torch.ops.beam_hop import BeamHop
    from flatnav_tpu_torch.utils import profiling

    n, b = 20_000, 64
    vectors, queries, links = _clustered_graph(cuda, n, 32, 16, b)
    labels = torch.arange(n, dtype=torch.int32, device=cuda)
    kw = {"k": 10, "ef": 64, "expand_factor": 32, **opts}
    score, entry = table_blocks(vectors, queries, MetricType.L2)
    hops, hop = hop_lockstep(links, score, entry, n, b, ef=kw["ef"], e_f=kw["expand_factor"],
                          hop_cap=kw.get("max_hops", 0))
    assert hops > 1 and (hop.workspace is not None) is spills
    del hop
    launches = BeamHop.launches
    profiling.snapshot(reset=True)
    with profiling.tracing():
        fused = batched_search(vectors, links, labels, n, queries, **kw)
    snap = profiling.snapshot(reset=True)
    hop_calls = sum(r["calls"] for p, r in snap["spans"].items() if p.endswith("search.hop"))
    assert snap["counters"]["search.hops_fused"] == hop_calls > 1
    assert BeamHop.launches - launches == 3 * hop_calls
    _chain_only(monkeypatch)
    chain = batched_search(vectors, links, labels, n, queries, **kw)
    assert _same_bits(fused.dists, chain.dists) and torch.equal(fused.labels, chain.labels)
    assert (fused.dist_computations, fused.hops) == (chain.dist_computations, chain.hops)
