"""Kernel K2 (flatnav_tpu_torch/ops/gather_distance.py) against the JAX
package's Pallas gather+distance kernel, run as the JAX tests run it (Pallas
interpret mode on the CPU).

On the CPU the port's wrapper takes its plain version, which must be
bit-equal to the port's `query_block_distances` over a gather (the CUDA
kernel is held to the same equality on the card, in
tests/test_torch_kernels_gpu.py). Against JAX the results
agree within 1e-6 of the result's magnitude: XLA may form FMAs per
program, the same residual tests/test_gather_distance.py documents.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flatnav_tpu.ops.distances import MetricType as JMetric
from flatnav_tpu.ops.gather_distance import gather_distances as jax_gather
from flatnav_tpu_torch.ops.distances import MetricType, _tree_sum_last, query_block_distances
from flatnav_tpu_torch.ops.gather_distance import gather_distances

METRICS = [(JMetric.L2, MetricType.L2), (JMetric.IP, MetricType.IP)]


def _close_to_jax(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * scale)


def _case(rng, n, b, c, d):
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    return vectors, ids, queries


@pytest.mark.parametrize("jm,tm", METRICS)
@pytest.mark.parametrize("shape", [(5, 37, 7), (16, 24, 37), (8, 512, 128)])
def test_plain_matches_jax_kernel(rng, shape, jm, tm):
    b, c, d = shape
    vectors, ids, queries = _case(rng, 1000, b, c, d)
    want = jax_gather(jnp.asarray(vectors), jnp.asarray(ids), jnp.asarray(queries),
                      jm, interpret=True)
    got = gather_distances(torch.from_numpy(vectors), torch.from_numpy(ids),
                           torch.from_numpy(queries), tm)
    _close_to_jax(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("jm,tm", METRICS)
@pytest.mark.parametrize("d", [7, 37, 128])
def test_plain_bit_equal_to_block_distances(rng, d, jm, tm, dtype):
    vectors, ids, queries = _case(rng, 300, 6, 41, d)
    v = torch.from_numpy(vectors).to(dtype)
    i = torch.from_numpy(ids)
    q = torch.from_numpy(queries)
    before = gather_distances.launches
    got = gather_distances(v, i, q, tm)
    assert gather_distances.launches == before  # CPU tensors never launch
    assert torch.equal(got, query_block_distances(q, v[i.long()], tm))


def test_bf16_table_matches_jax(rng):
    vectors, ids, queries = _case(rng, 500, 8, 64, 64)
    vj = jnp.asarray(vectors).astype(jnp.bfloat16)
    want = jax_gather(vj, jnp.asarray(ids), jnp.asarray(queries), JMetric.L2,
                      interpret=True)
    got = gather_distances(torch.from_numpy(vectors).to(torch.bfloat16),
                           torch.from_numpy(ids), torch.from_numpy(queries))
    _close_to_jax(got, want)


def _register_tree(terms: np.ndarray) -> np.ndarray:
    """numpy model of the CUDA kernel's reduction order over the last axis:
    lane l holds terms l + 32k (k < K = max(p/32, 1), zero past d), the tree
    levels h >= 32 are in-lane adds of register k + h/32 onto k, and the
    last levels (16 .. 1, or p/2 .. 1 for p < 32) add lane l + h onto lane
    l as __shfl_down_sync does (a lane past 31 reads its own value). Every
    add rounds to float32. The kernel takes this order up to p = 1024, and
    `_carry_stack_tree`'s from p = 2048; both are the fixed tree."""
    d = terms.shape[-1]
    p = 1 << max(0, d - 1).bit_length()
    k_regs = max(p // 32, 1)
    lanes = np.zeros(terms.shape[:-1] + (32 * k_regs,), np.float32)
    lanes[..., :d] = terms
    v = lanes.reshape(terms.shape[:-1] + (k_regs, 32))  # v[..., k, l] = term l + 32k
    h = k_regs // 2
    while h >= 1:
        v = v.copy()
        v[..., :h, :] = v[..., :h, :] + v[..., h : 2 * h, :]
        h //= 2
    x = v[..., 0, :]
    h = 16 if p >= 32 else p // 2
    while h >= 1:
        src = np.minimum(np.arange(32) + h, 31)
        shifted = np.where(np.arange(32) + h < 32, x[..., src], x)
        x = (x + shifted).astype(np.float32)
        h //= 2
    return x[..., 0]


@pytest.mark.parametrize("d", [1, 7, 31, 32, 33, 64, 128, 129, 130, 960, 1024, 2048, 3072, 4096])
def test_register_tree_order_is_the_fixed_tree(rng, d):
    # float32 sums of terms of mixed magnitude: any other association would
    # round differently somewhere in 64 rows
    terms = (rng.standard_normal((64, d)) * 10.0 ** rng.integers(-3, 4, (64, d))).astype(np.float32)
    want = _tree_sum_last(torch.from_numpy(terms)).numpy()
    got = _register_tree(terms)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


#: widths where the kernel forms its tree through a carry stack (p >= 2048):
#: OpenAI's 1536 and 3072, and past 4096
WIDE_DS = [1536, 3072, 4097, 5000, 8192]


@pytest.mark.parametrize("jm,tm", METRICS)
@pytest.mark.parametrize("d", WIDE_DS)
def test_plain_matches_jax_kernel_at_wide_d(rng, d, jm, tm):
    # JAX's Pallas kernel pads its tree to any p, so the port answers at
    # every d too (within the FMA residual above)
    vectors, ids, queries = _case(rng, 300, 4, 24, d)
    want = jax_gather(jnp.asarray(vectors), jnp.asarray(ids), jnp.asarray(queries),
                      jm, interpret=True)
    got = gather_distances(torch.from_numpy(vectors), torch.from_numpy(ids),
                           torch.from_numpy(queries), tm)
    _close_to_jax(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [4097, 8192])
def test_plain_bit_equal_to_block_distances_at_wide_d(rng, d, dtype):
    vectors, ids, queries = _case(rng, 200, 3, 17, d)
    v, i, q = torch.from_numpy(vectors).to(dtype), torch.from_numpy(ids), torch.from_numpy(queries)
    assert torch.equal(gather_distances(v, i, q), query_block_distances(q, v[i.long()], MetricType.L2))


def _bit_reversed(c: int, bits: int) -> int:
    return int(format(c, f"0{bits}b")[::-1], 2) if bits else 0


def _carry_stack_tree(terms: np.ndarray, dg: int = 8) -> np.ndarray:
    """numpy model of the CUDA kernel's reduction order from p = 2048 over
    the last axis: lane l holds terms l + 32k (k < K = p/32, zero past d).
    The tree's top in-lane level splits the even k from the odd k; each half
    is a fold in half over m = k // 2 < K/2, whose leaves, read left to
    right, are the m in bit-reversed order. A lane forms each half in nc =
    K/(2 dg) chunks of dg positions m = mc + nc*j (mc = chunk c
    bit-reversed): dg consecutive leaves, folded in half over j, then pushed
    onto a carry stack as a binary counter does (while bit s of c is set,
    the root is added onto slot s). The two halves' roots are added, then
    the five shuffle levels as in `_register_tree`. Every add rounds to
    float32. For p <= 32 only the shuffle levels remain."""
    d = terms.shape[-1]
    p = 1 << max(0, d - 1).bit_length()
    lanes = np.zeros(terms.shape[:-1] + (max(p, 32),), np.float32)
    lanes[..., :d] = terms
    if p <= 32:
        x = lanes[..., :32]
    else:
        half_k = p // 64
        g = min(dg, half_k)
        nc = half_k // g
        lg = nc.bit_length() - 1
        roots = []
        for half in range(2):  # the even k, then the odd k
            stack = {}
            for c in range(nc):
                mc = _bit_reversed(c, lg)
                v = np.stack([lanes[..., 64 * (mc + nc * j) + 32 * half:][..., :32]
                              for j in range(g)], axis=-2)  # [..., g, 32]
                h = g // 2
                while h >= 1:
                    v = v.copy()
                    v[..., :h, :] = v[..., :h, :] + v[..., h : 2 * h, :]
                    h //= 2
                x, s = v[..., 0, :], 0
                while (c >> s) & 1:
                    x = (stack[s] + x).astype(np.float32)
                    s += 1
                stack[s] = x
            roots.append(x)
        x = (roots[0] + roots[1]).astype(np.float32)
    h = 16 if p >= 32 else p // 2
    while h >= 1:
        src = np.minimum(np.arange(32) + h, 31)
        shifted = np.where(np.arange(32) + h < 32, x[..., src], x)
        x = (x + shifted).astype(np.float32)
        h //= 2
    return x[..., 0]


# every p from 1 to 16,384, at a power of two and past one
@pytest.mark.parametrize("d", [1, 2, 3, 7, 16, 31, 32, 33, 64, 100, 128, 200, 256, 500, 512,
                               513, 1024, 1536, 2048, 3072, 4096, 4097, 5000, 8192, 12000,
                               16384])
def test_carry_stack_order_is_the_fixed_tree(rng, d):
    terms = (rng.standard_normal((64, d)) * 10.0 ** rng.integers(-3, 4, (64, d))).astype(np.float32)
    want = _tree_sum_last(torch.from_numpy(terms)).numpy()
    got = _carry_stack_tree(terms)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm", [MetricType.L2, MetricType.IP])
def test_out_gets_the_same_values(rng, tm, dtype):
    # the search's captured hop hands K2 the tensor its merge reads; on the
    # CPU the plain version writes its result there and returns it
    vectors, ids, queries = _case(rng, 200, 6, 40, 24)
    v, i, q = torch.from_numpy(vectors).to(dtype), torch.from_numpy(ids), torch.from_numpy(queries)
    out = torch.full((6, 40), 7.0)
    got = gather_distances(v, i, q, tm, out=out)
    assert got is out
    assert torch.equal(out.view(torch.int32), gather_distances(v, i, q, tm).view(torch.int32))
    with pytest.raises(ValueError, match="out"):
        gather_distances(v, i, q, tm, out=torch.empty((6, 39)))
