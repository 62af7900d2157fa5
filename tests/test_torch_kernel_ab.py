"""CPU tests of the kernel A/B tool: a baseline's C entry is called with the
parameters its own source declares, by name."""

import ctypes

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


def test_this_checkouts_k1_entry_takes_the_query_type():
    # the entry kernel_ab calls this checkout's baselines through, and the
    # names the north-star cases pass (the parent's entry lacks q_type)
    src = (_build.CSRC / "fused_scan.cu").read_text()
    entry = kernel_ab.BaseEntry(_Lib(), src, "fused_scan_launch")
    assert entry.names == ["q", "q_type", "rows", "row_type", "pen", "qc", "n", "d", "nlim",
                           "t", "L", "nb", "variant", "out_min", "out_id", "stream"]
    assert set(kernel_ab.K1_CASES) == {"1M", "path", "gist", "angular", "u8-10M", "u8-100M"}


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
