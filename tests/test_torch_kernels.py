"""Port parity: the K1/K2 wrappers (plain versions on the CPU) against the
reference's Pallas kernels in interpret mode and its jit'd ops.

K1 (binarize + bitpack) must match bit for bit, stochastic included, since
both sides get the same numpy-made uint32 words. K2 (packed-weight matmul)
holds the reference's own tolerances: f32 rtol 1e-4 / atol 1e-3 (the sum
order differs), bf16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.binary_matmul import binary_matmul_pallas
from repro.kernels.stoch_binarize import binarize_pack_pallas
from repro_torch.core import packing as P
from repro_torch.core import prng
from repro_torch.kernels import ops, ref
from repro_torch.kernels.binary_matmul import binary_matmul
from repro_torch.kernels.stoch_binarize import binarize_pack, binarize_pack_plain

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _ceil(a, b):
    return -(-a // b) * b


def _weights_and_words(k, n, seed):
    """Weights with +-1, -0.0 and p >= 1 rows, and uint32 words whose first
    rows hold the top 128 values (which round to 2^32 in f32)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.7, (k, n)).astype(np.float32)
    w[0], w[1 % k], w[2 % k], w[3 % k] = 1.0, -1.0, -0.0, 1.25
    bits = rng.integers(0, 2**32, (k, n), dtype=np.uint64).astype(np.uint32)
    top = (2**32 - 1 - np.arange(4 * n) % 128).astype(np.uint32).reshape(4, n)
    bits[: min(k, 4)] = top[: min(k, 4)]
    return w, bits


def _pallas_pack(w, bits, stochastic):
    """The reference kernel in interpret mode on a 256-block-padded copy."""
    k, n = w.shape
    kp, np_ = _ceil(k, 256), _ceil(n, 256)
    wp = np.full((kp, np_), -1.0, np.float32)
    wp[:k, :n] = w
    bp = np.zeros((kp, np_), np.uint32)
    bp[:k, :n] = bits
    out = binarize_pack_pallas(jnp.asarray(wp), jnp.asarray(bp) if stochastic else None,
                               stochastic=stochastic, interpret=True)
    return np.asarray(out)[: -(-k // 32), :n]


@pytest.mark.parametrize("k,n", [(256, 256), (512, 384), (300, 100), (33, 7), (1000, 1500)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_k1_matches_pallas_kernel(k, n, stochastic):
    w, bits = _weights_and_words(k, n, k * 7 + n)
    want = _pallas_pack(w, bits, stochastic)
    got = binarize_pack(torch.from_numpy(w), torch.from_numpy(bits.view(np.int32))
                        if stochastic else None, stochastic=stochastic)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", [(1000, 1500), (4608, 512), (70, 40000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stochastic", [False, True])
def test_k1_cpu_blocks_equal_the_whole_leaf(k, n, dtype, stochastic):
    """On the CPU, K1 packs a leaf a block of ``HOST_BLOCK`` weights at a time
    (ragged K and N past one block in each dimension; one word row wider
    than a block): the words of the plain version over the whole leaf."""
    w, bits = _weights_and_words(k, n, k + n)
    wt = torch.from_numpy(w).to(dtype)
    bt = torch.from_numpy(bits.view(np.int32)) if stochastic else None
    got = binarize_pack(wt, bt, stochastic=stochastic)
    assert torch.equal(got, binarize_pack_plain(wt, bt, stochastic=stochastic))


@pytest.mark.parametrize("k,n", [(256, 128), (96, 40)])
def test_k1_bf16_matches_reference(k, n):
    w, bits = _weights_and_words(k, n, 5)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    np.testing.assert_array_equal(
        binarize_pack(wt, torch.from_numpy(bits.view(np.int32)), stochastic=True).numpy(),
        np.asarray(jref.stoch_binarize_pack_ref(wj, jnp.asarray(bits))))
    np.testing.assert_array_equal(binarize_pack(wt, stochastic=False).numpy(),
                                  np.asarray(jref.det_binarize_pack_ref(wj)))


@pytest.mark.parametrize("k,n", [(256, 256), (300, 100)])
def test_binarize_and_pack_det_matches_reference_ops(k, n):
    w, _ = _weights_and_words(k, n, 11)
    got = ops.binarize_and_pack(torch.from_numpy(w), stochastic=False)
    want = np.asarray(jops.binarize_and_pack(jnp.asarray(w), stochastic=False))
    assert got.shape == (-(-k // 32), n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.1, 0.25, 0.5, 0.75, 0.9])
def test_eq3_frequency_of_generator_path(p):
    """Eq. 2-3 through ops.binarize_and_pack with words drawn from a key
    (the threefry twin): the fraction of +1 bits is hard_sigmoid(w) within
    4 sigma."""
    w = torch.full((512, 512), 2.0 * p - 1.0)
    packed = ops.binarize_and_pack(w, prng.key(3), stochastic=True)
    frac = float((P.unpack_bits(packed) > 0).float().mean())
    assert abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / w.numel())


def test_stochastic_pack_needs_words_or_generator():
    with pytest.raises(ValueError, match="requires a key"):
        ops.binarize_and_pack(torch.zeros(64, 8), stochastic=True)


def _matmul_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    wp = np.array(jref.det_binarize_pack_ref(jnp.asarray(w)))
    return x, wp, scale


@pytest.mark.parametrize("m,k,n", [(128, 512, 128), (256, 1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scaled", [False, True])
def test_k2_matches_pallas_kernel(m, k, n, dtype, scaled):
    x, wp, scale = _matmul_inputs(m, k, n, m + k + n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = binary_matmul_pallas(jnp.asarray(x), jnp.asarray(wp),
                                jnp.asarray(scale) if scaled else None,
                                block_k=256, compute_dtype=jdt, interpret=True)
    got = binary_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(wp), torch.from_numpy(scale) if scaled else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("shape", [(200, 512), (8, 512), (4, 32, 512), (3, 2048)])
@pytest.mark.parametrize("n", [100, 128])
@pytest.mark.parametrize("scaled", [False, True])
def test_binary_matmul_matches_reference_ops(shape, n, scaled):
    """Through both packages' ops: leading dims flatten, f32 stays f32."""
    k = shape[-1]
    rng = np.random.default_rng(sum(shape) + n)
    x = rng.normal(size=shape).astype(np.float32)
    _, wp, scale = _matmul_inputs(2, k, n, n)
    s = scale if scaled else None
    want = np.asarray(jops.binary_matmul(jnp.asarray(x), jnp.asarray(wp),
                                         None if s is None else jnp.asarray(s)))
    got = ops.binary_matmul(torch.from_numpy(x), torch.from_numpy(wp),
                            None if s is None else torch.from_numpy(s))
    assert tuple(got.shape) == shape[:-1] + (n,)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_binary_matmul_non_f32_computes_in_bf16(dtype):
    x, wp, scale = _matmul_inputs(16, 256, 64, 9)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = ops.binary_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(wp), torch.from_numpy(scale))
    want = jops.binary_matmul(xj, jnp.asarray(wp), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)


@pytest.mark.parametrize("k", [1, 31, 100])
def test_binary_matmul_ragged_k_ignores_pad_bits(k):
    """K need not be a multiple of 32: bits past K do not contribute."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(5, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, 9)).astype(np.float32))
    wp = ops.binarize_and_pack(w, stochastic=False)
    wp[-1] |= -(1 << 31)                     # bit 31 of the last word is a pad bit
    dense = x @ torch.where(w > 0, 1.0, -1.0)
    torch.testing.assert_close(ops.binary_matmul(x, wp), dense, **F32_TOL)
    torch.testing.assert_close(ref.binary_matmul_ref(x, wp), ops.binary_matmul(x, wp))
