"""CPU tests of the kernel A/B tool: a baseline's C entry is called with the
parameters its own source declares, by name."""

import ctypes

import numpy as np

import pytest
import torch

from flatnav_tpu_torch import _build
from flatnav_tpu_torch.bench import kernel_ab

# the K1 entry without and with the `variant` parameter, and the K2 entry
K1_OLD = '''extern "C" int fused_scan_launch(const void* q, const void* rows, int row_type,
                                 const void* pen, int qc, int n, int d,
                                 int nlim, int t, int L, int nb, void* out_min,
                                 void* out_id, void* stream) {'''
K1_VARIANT = K1_OLD.replace("int nb, void* out_min", "int nb, int variant,\n void* out_min")
K2 = '''// comment
extern "C" int gather_distance_launch(const void* vec, int vec_type,
                                      const void* ids, const void* q, int n,
                                      int d, int B, int C, int ip, void* out,
                                      void* stream) {'''


class _Fn:
    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


class _Lib:
    def __init__(self):
        self.fused_scan_launch = _Fn()
        self.gather_distance_launch = _Fn()
        self.select_k_launch = _Fn()


K1_VALUES = dict(q=1, rows=2, row_type=0, pen=3, qc=4, n=5, d=6, nlim=7, t=8, L=9, nb=10,
                 variant=1, out_min=11, out_id=12, stream=13)


@pytest.mark.parametrize("src,want", [
    (K1_OLD, (1, 2, 0, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)),
    (K1_VARIANT, (1, 2, 0, 3, 4, 5, 6, 7, 8, 9, 10, 1, 11, 12, 13)),
])
def test_baseline_entry_passes_arguments_by_name(src, want):
    lib = _Lib()
    entry = kernel_ab.BaseEntry(lib, src, "fused_scan_launch")
    entry(**K1_VALUES)
    assert lib.fused_scan_launch.args == want
    ptrs = {"q", "rows", "pen", "out_min", "out_id", "stream"}
    assert lib.fused_scan_launch.argtypes == [
        ctypes.c_void_p if n in ptrs else ctypes.c_int for n in entry.names]


def test_baseline_entry_reads_the_k2_signature():
    lib = _Lib()
    entry = kernel_ab.BaseEntry(lib, "int x;\n" + K2, "gather_distance_launch")
    assert entry.names == ["vec", "vec_type", "ids", "q", "n", "d", "B", "C", "ip", "out",
                           "stream"]


def test_baseline_entry_refuses_unknown_parameters():
    src = K1_OLD.replace("int nb,", "int nb, int mystery,")
    entry = kernel_ab.BaseEntry(_Lib(), src, "fused_scan_launch")
    with pytest.raises(ValueError, match="mystery"):
        entry(**K1_VALUES)


def test_baseline_entry_needs_the_declaration():
    with pytest.raises(ValueError, match="fused_scan_launch"):
        kernel_ab.BaseEntry(_Lib(), K2, "fused_scan_launch")


def test_baseline_entry_checks_the_return_code():
    lib = _Lib()
    lib.gather_distance_launch = lambda *args: 1
    entry = kernel_ab.BaseEntry(lib, K2, "gather_distance_launch")
    with pytest.raises(RuntimeError):
        entry(vec=0, vec_type=0, ids=0, q=0, n=0, d=0, B=0, C=0, ip=0, out=0, stream=0)


def test_this_checkouts_entries_are_readable():
    # the tool can take this checkout's own sources as the baseline
    for stem, name in kernel_ab._SOURCES.values():
        src = (_build.CSRC / f"{stem}.cu").read_text()
        entry = kernel_ab.BaseEntry(_Lib(), src, name)
        assert entry.names[-1] == "stream"


def test_main_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--baseline", str(tmp_path)]) == 2


def test_main_takes_several_baselines(monkeypatch, tmp_path):
    # K1 copies after the first baseline are timed beside it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--cases", "k1", "--baseline", str(tmp_path), str(tmp_path / "b"),
                           str(tmp_path / "c")]) == 2


def test_launch_as_passes_the_c_entrys_parameters_in_order(monkeypatch):
    # the one place that launches K1 as a chosen variant (the wrapper, the
    # bench's other variants) passes what the entry's own source declares
    from types import SimpleNamespace

    from flatnav_tpu_torch.ops import fused_scan as fs

    fn = _Fn()
    monkeypatch.setattr(fs, "_lib", lambda: fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: SimpleNamespace(cuda_stream=7))
    q = torch.zeros((5, 100), dtype=torch.bfloat16)
    rows = torch.zeros((4096, 100), dtype=torch.int8)
    pen = torch.zeros(4096)
    out_min, out_id = torch.zeros((5, 256)), torch.zeros((5, 256), dtype=torch.int32)
    assert fs.launch_as("wgmma_mixed", q, rows, pen, 4000, 2048, 16, out_min, out_id) == 0
    src = (_build.CSRC / "fused_scan.cu").read_text()
    names = kernel_ab.BaseEntry(_Lib(), src, "fused_scan_launch").names
    want = dict(q=q.data_ptr(), q_type=fs._ROW_TYPES[torch.bfloat16], rows=rows.data_ptr(),
                row_type=fs._ROW_TYPES[torch.int8], pen=pen.data_ptr(), qc=5, n=4096, d=100,
                nlim=4000, t=2048, L=16, nb=256, variant=fs.VARIANTS["wgmma_mixed"],
                out_min=out_min.data_ptr(), out_id=out_id.data_ptr(), stream=7)
    assert fn.args == tuple(want[n] for n in names)


def test_this_checkouts_k1_entry_takes_the_query_type():
    # the entry kernel_ab calls this checkout's baselines through, and the
    # names the north-star cases pass (the parent's entry lacks q_type)
    src = (_build.CSRC / "fused_scan.cu").read_text()
    entry = kernel_ab.BaseEntry(_Lib(), src, "fused_scan_launch")
    assert entry.names == ["q", "q_type", "rows", "row_type", "pen", "qc", "n", "d", "nlim",
                           "t", "L", "nb", "variant", "out_min", "out_id", "stream"]
    assert set(kernel_ab.K1_CASES) == {"1M", "path", "gist", "angular", "u8-10M", "u8-100M",
                                       "u8-10M-bf16q", "spacev-10M", "spacev-100M",
                                       "spacev-10M-bf16q", "glove-25", "glove-50",
                                       "openai-1536", "openai-3072"}


@pytest.mark.parametrize("name", ["u8-10M", "u8-100M", "u8-10M-bf16q", "spacev-10M", "spacev-100M",
                                  "spacev-10M-bf16q", "glove-25", "glove-50", "openai-1536",
                                  "openai-3072"])
def test_k1_cases_take_the_shapes_fused_knn_picks(name):
    # T, L and the query chunk of each case are fused_knn's for its table;
    # the bf16 tables at the width of their padded copy
    from flatnav_tpu_torch.ops import fused_scan as fs

    qc, n, _, d, dtype, qdtype, t, L, _ = kernel_ab.K1_CASES[name]
    width = d if dtype != torch.bfloat16 else -(-d // 8) * 8
    isz = 2 if dtype == torch.bfloat16 else 1
    got = fs._pick_shapes(n, qc, width, isz, fs._TILE, fs._QB, None, fs._SUMMARY_BYTES)
    assert (got[0], got[1], got[3]) == (L, t, qc)


def test_spacev_bound_is_at_the_tables_width():
    # the int8 rate at d=100, not at a padded width: about 4.1 ms at 10M
    from flatnav_tpu_torch.bench.measure import INT8_OP_PER_S, scan_bound

    qc, n, nlim, d, _, _, t, L, _ = kernel_ab.K1_CASES["spacev-10M"]
    ms, by = scan_bound(qc, n, d, -(-n // t) * (t // L), row_bytes=1, q_bytes=1)
    assert by == "operations" and ms == pytest.approx(2 * qc * n * 100 / INT8_OP_PER_S * 1e3)
    assert ms == pytest.approx(4.1394, abs=1e-4)


@pytest.mark.parametrize("name,want", [("spacev-10M-bf16q", 8.2831), ("u8-10M-bf16q", 10.6024)])
def test_bf16_query_cases_are_bound_at_the_bf16_rate(name, want):
    # 8-bit rows against bf16 queries ("wgmma_mixed") are bf16 products, at
    # the table's own width: 2 * 4096 * 10^7 * d operations at 989 TFLOP/s
    from flatnav_tpu_torch.bench.measure import scan_bound
    from flatnav_tpu_torch.ops.fused_scan import scan_variant

    qc, n, nlim, d, dtype, qdtype, t, L, _ = kernel_ab.K1_CASES[name]
    ms, by = scan_bound(qc, n, d, -(-n // t) * (t // L), row_bytes=1, q_bytes=2)
    assert by == "operations" and ms == pytest.approx(want, abs=1e-4)
    rows = torch.zeros((2 * t, d), dtype=dtype)
    q = torch.zeros((8, d), dtype=qdtype)
    assert scan_variant(q, rows, torch.zeros(2 * t), t, L) == "wgmma_mixed"


def test_scan_bound_counts_8bit_products_at_the_int8_rate():
    from flatnav_tpu_torch.bench.measure import BF16_FLOP_PER_S, INT8_OP_PER_S, scan_bound

    qc, n, d, nb = 4096, 10_000_000, 128, 10_000_000 // 128
    ms8, by8 = scan_bound(qc, n, d, nb, row_bytes=1, q_bytes=1)
    assert by8 == "operations" and ms8 == pytest.approx(2 * qc * n * d / INT8_OP_PER_S * 1e3)
    ms_bf, _ = scan_bound(qc, n, d, nb, row_bytes=1)  # bf16 queries: bf16 products
    assert ms_bf == pytest.approx(2 * qc * n * d / BF16_FLOP_PER_S * 1e3)
    assert ms8 == pytest.approx(5.2985, abs=1e-4)  # the 10M cell's bound


def test_k3_cases_are_shapes_k3_takes():
    from flatnav_tpu_torch.ops.select_k import K_MAX, _plan

    for name, (b, w, k, ids, keys) in kernel_ab.K3_CASES.items():
        assert 1 <= k <= min(w, K_MAX) and ids in ("full", "row", "implicit"), name
        assert keys in ("normal", "ties") and _plan(b, w, k)[-1][0] >= k, name


def test_ab_cases_need_a_baseline():
    with pytest.raises(SystemExit):
        kernel_ab.main(["--cases", "k1,k3"])
    if not torch.cuda.is_available():  # k3 alone needs no baseline, only a card
        assert kernel_ab.main(["--cases", "k3"]) == 2


# the K3 entry of the parent (no prior, no route) and of this checkout
K3_OLD = '''extern "C" int select_k_launch(const void* keys, const void* ids, int id_rows, int id_base,
                               const void* pairs, int B, int W, int k, int col_lo,
                               int col_hi, int slice, void* out_d, void* out_i,
                               void* out_pairs, void* stream) {'''


class _Recorder:
    """A baseline entry that records the values of every call by name."""

    def __init__(self, src):
        self.calls = []
        self.entry = kernel_ab.BaseEntry(_Lib(), src, "select_k_launch")
        self.names = self.entry.names

    def __call__(self, **values):
        self.calls.append({n: values[n] for n in self.names})


def test_k3_entries_are_read_by_name():
    old = _Recorder(K3_OLD)
    assert old.names == ["keys", "ids", "id_rows", "id_base", "pairs", "B", "W", "k", "col_lo",
                         "col_hi", "slice", "out_d", "out_i", "out_pairs", "stream"]
    new = _Recorder((_build.CSRC / "select_k.cu").read_text())
    assert new.names == ["keys", "ids", "id_rows", "id_base", "pairs", "prior_d", "prior_i", "B",
                         "W", "k", "col_lo", "col_hi", "slice", "route", "out_d", "out_i",
                         "out_pairs", "stream"]


@pytest.mark.parametrize("b,w,k,rounds", [(4096, 131_072, 32, 1), (1, 131_072, 32, 2),
                                          (512, 390_656, 32, 2)])
def test_base_select_drives_the_parents_rounds(monkeypatch, b, w, k, rounds):
    # the parent's wrapper: the rounds of _plan, each later one over the
    # words of the one before, the column window on the first round only
    monkeypatch.setattr(kernel_ab, "_stream", lambda: 7)
    base = _Recorder(K3_OLD)
    keys = torch.zeros((b, w), device="meta")
    _, n = kernel_ab.base_select(base, keys, k, id_base=3, cols=(5, w - 5))
    assert n == rounds == len(base.calls)
    first, last = base.calls[0], base.calls[-1]
    assert first["pairs"] is None and first["id_base"] == 3
    assert (first["col_lo"], first["col_hi"]) == (5, w - 5)
    assert (last["out_pairs"] is None) and last["out_d"] is not None
    if rounds > 1:
        assert last["keys"] is None and last["pairs"] is not None and last["col_lo"] == 0


def test_base_merge_tile_is_two_selections(monkeypatch):
    monkeypatch.setattr(kernel_ab, "_stream", lambda: 7)
    base = _Recorder(K3_OLD)
    best_d, best_i = torch.zeros((64, 32), device="meta"), torch.zeros(
        (64, 32), dtype=torch.int32, device="meta")
    _, n = kernel_ab.base_merge_tile(base, best_d, best_i, torch.zeros((64, 4096), device="meta"), 9)
    assert n == 2 and base.calls[0]["id_base"] == 9 and base.calls[1]["W"] == 64
    assert base.calls[1]["ids"] is not None  # the merge reads the concatenated ids


def test_k3_seeded_cases_and_the_k3_baseline_option(monkeypatch, tmp_path):
    from flatnav_tpu_torch.ops.select_k import K_MAX

    for name, (b, w, k, ids, keys) in kernel_ab.K3_SEEDED.items():
        assert name not in kernel_ab.K3_CASES and ids == "implicit" and 1 <= k <= K_MAX
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # k3 takes a baseline but does not need one; both stop without a card
    assert kernel_ab.main(["--cases", "k3", "--baseline", str(tmp_path)]) == 2
    assert kernel_ab.main(["--cases", "k3", "--k3", "merge-tile,build"]) == 2


@pytest.mark.parametrize("b,w,k,routes", [(8192, 8192, 64, ["warp"]), (16384, 196, 8, ["warp"]),
                                          (4096, 131_072, 32, ["block"]),
                                          (1, 131_072, 32, ["warp", "warp"]),
                                          (512, 390_656, 32, ["block", "warp"]),
                                          (1024, 32_768, 1024, ["block", "block"])])
def test_base_select_passes_the_wrappers_route(monkeypatch, b, w, k, routes):
    # a baseline of this generation is driven through the wrapper's own
    # rounds, so it takes the route the wrapper would pick on each round
    from flatnav_tpu_torch.ops.select_k import ROUTES

    monkeypatch.setattr(kernel_ab, "_stream", lambda: 7)
    new = _Recorder((_build.CSRC / "select_k.cu").read_text())
    _, n = kernel_ab.base_select(new, torch.zeros((b, w), device="meta"), k)
    assert n == len(routes) and [c["route"] for c in new.calls] == [ROUTES[r] for r in routes]
    assert all(c["prior_d"] is None and c["prior_i"] is None and c["stream"] == 7
               for c in new.calls)


@pytest.mark.parametrize("ids,extra", [("implicit", 0), ("row", 4), ("full", 4)])
@pytest.mark.parametrize("prior", [False, True])
def test_select_bound_counts_the_bytes_the_selection_needs(ids, extra, prior):
    # each key once, the result once, a prior once, and only the returned
    # ids of an id tensor or row (the rest need not be read)
    from flatnav_tpu_torch.bench.measure import HBM_BYTES_PER_S, select_bound

    b, w, k = 4096, 62_592, 32
    ms, by = select_bound(b, w, k, ids=ids, prior=prior)
    nbytes = b * w * 4 + b * k * 8 + (b * k * 8 if prior else 0) + b * k * extra
    assert by == "bytes" and ms == pytest.approx(nbytes / HBM_BYTES_PER_S * 1e3, rel=1e-12)
    with pytest.raises(ValueError):
        select_bound(b, w, k, ids="some")


def test_phase_b_bound_is_the_keys_and_the_result():
    from flatnav_tpu_torch.bench.measure import select_bound

    # fused_knn's phase B at 1M x 128: the keys alone give 0.3061 ms
    ms, _ = select_bound(4096, 62_592, 32, ids="full")
    assert ms == pytest.approx(0.3066, abs=1e-4)


def test_k2_cases_hold_the_hop_and_the_wave_at_openai_widths():
    # the parent's d=4096 hop (20,000 rows) is still a case, beside d=1536,
    # 3072 and 8192 hops and a build wave at d=1536
    assert kernel_ab.K2_CASES["hop-4096"] == (1024, 512, 20_000, 4096, torch.float32)
    for d in (1536, 3072, 8192):
        assert kernel_ab.K2_CASES[f"hop-{d}"][:2] == (1024, 512)
    assert kernel_ab.K2_CASES["wave-1536"][:2] + kernel_ab.K2_CASES["wave-1536"][3:4] == (
        8192, 1024, 1536)


@pytest.mark.parametrize("d", [7, 1536, 5000])
def test_plain_in_chunks_equals_the_plain_version(d):
    rng = np.random.default_rng(d)
    v = torch.from_numpy(rng.standard_normal((50, d), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (9, 11)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((9, d), dtype=np.float32))
    got = kernel_ab._plain_in_chunks(v, ids, q, budget=3 * 11 * 8192 * 4)
    assert torch.equal(got, kernel_ab.gather_distances_plain(v, ids, q))


def test_openai_bound_counts_operations():
    # 2 * 4096 * 1M * 1536 products at 989 TFLOP/s: about 12.7 ms
    from flatnav_tpu_torch.bench.measure import BF16_FLOP_PER_S, scan_bound

    qc, n, _, d, _, _, t, L, _ = kernel_ab.K1_CASES["openai-1536"]
    ms, by = scan_bound(qc, n, d, -(-n // t) * (t // L))
    assert by == "operations" and ms == pytest.approx(2 * qc * n * d / BF16_FLOP_PER_S * 1e3)
    assert ms == pytest.approx(12.7229, abs=1e-4)
