"""The benchmark's copied bounds read what the port's `bench/measure.py` reads."""

from __future__ import annotations

import pytest
import torch

from annbench import bounds
from flatnav_tpu_torch.bench import measure

SHAPES = [(64, 512, 128), (1000, 2048, 128), (1000, 512, 960)]


@pytest.mark.parametrize("b,c,d", SHAPES)
def test_gather_bound(b, c, d):
    g = torch.Generator().manual_seed(b + c + d)
    vectors = torch.zeros((20000, d))
    ids = torch.randint(0, 20000, (b, c), generator=g, dtype=torch.int32)
    q = torch.zeros((b, d))
    assert bounds.gather_bound(vectors, ids, q) == measure.gather_bound(vectors, ids, q)
    assert bounds.gather_call(vectors, ids, q, None) == measure.gather_bound(vectors, ids, q)[0]


@pytest.mark.parametrize("qc,n,d,nb,rb,qb", [(1000, 10**6, 128, 62592, 2, 2),
                                             (1000, 10**6, 960, 62592, 2, 2),
                                             (4096, 10**7, 128, 39168, 1, 1)])
def test_scan_bound(qc, n, d, nb, rb, qb):
    assert bounds.scan_bound(qc, n, d, nb, rb, qb) == measure.scan_bound(qc, n, d, nb, rb, qb)


@pytest.mark.parametrize("b,w,k,ids,prior", [(1000, 62592, 32, "full", False),
                                             (4096, 131072, 32, "implicit", True),
                                             (8192, 8192, 32, "row", False)])
def test_select_bound(b, w, k, ids, prior):
    assert bounds.select_bound(b, w, k, ids, prior) == measure.select_bound(b, w, k, ids, prior)


def test_calls_read_the_wrappers_arguments():
    q = torch.zeros((1000, 128), dtype=torch.bfloat16)
    rows = torch.zeros((1 << 20, 128), dtype=torch.bfloat16)
    nb = (1 << 20) // 16
    assert bounds.scan_call(q, rows, None, 1 << 20, 2048, 16) == measure.scan_bound(
        1000, 1 << 20, 128, nb)[0]
    keys = torch.zeros((1000, 62592))
    full = torch.zeros((1000, 62592), dtype=torch.int32)
    row = torch.zeros((1, 62592), dtype=torch.int32).expand(1000, -1)
    assert bounds.select_call(keys, 32, ids=full) == measure.select_bound(1000, 62592, 32, "full")[0]
    assert bounds.select_call(keys, 32, ids=row) == measure.select_bound(1000, 62592, 32, "row")[0]
    prior = (torch.zeros((1000, 32)), torch.zeros((1000, 32), dtype=torch.int32))
    assert bounds.select_call(keys, 32, id_base=5, prior=prior) == measure.select_bound(
        1000, 62592, 32, "implicit", True)[0]
