"""The copied generator draws the same arrays for one seed, other arrays for
another, at the configuration's shapes."""

from __future__ import annotations

import pytest
import torch

from annbench import synth


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_same_seed_same_arrays(seed):
    a = synth.clustered(4096, 24, 100, seed, "cpu")
    b = synth.clustered(4096, 24, 100, seed, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (4096, 24) and a[1].shape == (100, 24)
    assert a[0].dtype == a[1].dtype == torch.float32


def test_other_seed_other_arrays():
    a, _ = synth.clustered(4096, 24, 100, 1, "cpu")
    b, _ = synth.clustered(4096, 24, 100, 2, "cpu")
    assert not torch.equal(a, b)


def test_mixture_shape():
    """Queries are rows moved by unit noise: each query's nearest row lies
    about sqrt(d) away, nearer than the cluster's spread."""
    data, q = synth.clustered(65536, 32, 64, 5, "cpu", centers_per_64k=26)
    nearest = torch.cdist(q, data).min(1).values
    assert float(nearest.median()) < 1.5 * 32**0.5
    assert abs(float(data.std()) - (1 + 0.49) ** 0.5) < 0.1


def test_generate_reads_the_config():
    cfg = {"n": 1000, "dim": 8, "num_queries": 10, "metric": "l2", "dtype": "float32",
           "generator": {"kind": "clustered", "centers_per_64k": 26, "center_scale": 0.7,
                         "query_noise": 1.0}}
    data, q = synth.generate(cfg, 3, "cpu")
    assert data.shape == (1000, 8) and q.shape == (10, 8)
    with pytest.raises(ValueError):
        synth.generate({**cfg, "generator": {"kind": "uniform"}}, 3, "cpu")
