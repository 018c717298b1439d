"""Port parity: K1's on-chip-PRNG variant (``binarize_pack(..., on_chip_prng=True)``).

The reference's ``_stoch_kernel_tpu_prng`` draws the TPU's hardware bits,
which nothing else reproduces, so the port's variant is held to three
things: its Philox4x32-10 stream (known-answer vectors and a scalar Python
Philox); its rule, bit for bit against the reference's operand kernel in
interpret mode fed the same words (the reference documents one kernel body
for both variants); and the Eq.-3 frequency with exact endpoints, as
``tests/test_stoch_ensemble.py`` checks the reference's sampler.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro_torch.core import packing as P
from repro_torch.kernels.stoch_binarize import (binarize_pack, binarize_pack_plain,
                                                onchip_words, philox4x32_10)
from test_torch_kernels import _pallas_pack

_MASK = 0xFFFFFFFF


def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints, written from the Random123 definition."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK, (k1 + 0xBB67AE85) & _MASK
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & _MASK, p1 & _MASK,
             ((p0 >> 32) ^ c[3] ^ k1) & _MASK, p0 & _MASK]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_MASK,) * 4, (_MASK,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(tuple(torch.tensor([c]) for c in ctr), key)
    assert tuple(int(g) for g in got) == want
    assert tuple(_philox_scalar(ctr, key)) == want


@pytest.mark.parametrize("seed", [0, 12345, 2**32 + 7, -3])
def test_onchip_words_match_scalar_philox(seed):
    k, n = 11, 70001
    words = onchip_words(seed, k, n).numpy().view(np.uint32)
    assert words.shape == (k, n)
    for r, c in [(0, 0), (1, 0), (2, 5), (3, 65535), (5, 65536), (7, 70000), (10, 12345)]:
        want = _philox_scalar((r >> 2, c, 0, 0), (seed % 2**32, 0))[r & 3]
        assert int(words[r, c]) == want, (r, c)


def test_onchip_words_ignore_the_launch_shape():
    """Word (k, n) is the same whatever (K, N) it is drawn in."""
    big = onchip_words(9, 70, 50)
    assert torch.equal(onchip_words(9, 33, 7), big[:33, :7])


def test_onchip_words_follow_the_seed():
    a, b, c = onchip_words(1, 64, 64), onchip_words(1, 64, 64), onchip_words(2, 64, 64)
    assert torch.equal(a, b)
    assert (a != c).float().mean() > 0.99


def _weights(k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.7, (k, n)).astype(np.float32)
    w[0], w[1 % k], w[2 % k], w[3 % k] = 1.0, -1.0, -0.0, 1.25
    wt = torch.from_numpy(w).to(dtype)
    return wt, wt.float().numpy()     # the values the kernel sees, in f32


@pytest.mark.parametrize("k,n", [(2048, 2048), (784, 2048), (100, 300), (33, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onchip_pack_matches_pallas_operand_kernel(k, n, dtype):
    seed = k * n + 3
    wt, w32 = _weights(k, n, seed, dtype)
    words = onchip_words(seed, k, n).numpy().view(np.uint32)
    want = _pallas_pack(w32, words, stochastic=True)
    got = binarize_pack(wt, stochastic=True, seed=seed, on_chip_prng=True)
    assert got.dtype == torch.int32 and got.shape == ((k + 31) // 32, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.1, 0.25, 0.5, 0.75, 0.9])
def test_onchip_eq3_frequency(p):
    """The fraction of +1 bits is hard_sigmoid(w) within 4 sigma."""
    w = torch.full((512, 512), 2.0 * p - 1.0)
    packed = binarize_pack(w, stochastic=True, seed=int(p * 1000), on_chip_prng=True)
    frac = float((P.unpack_bits(packed) > 0).float().mean())
    assert abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / w.numel())


@pytest.mark.parametrize("value,bit", [(1.0, 1), (1.5, 1), (-1.0, 0), (-2.0, 0)])
def test_onchip_endpoints_are_exact(value, bit):
    """p = 1 gives bit 1 and p = 0 bit 0 for every word, the top 128 included."""
    w = torch.full((256, 256), value)
    packed = binarize_pack(w, stochastic=True, seed=5, on_chip_prng=True)
    assert torch.equal(P.unpack_bits(packed), torch.full((256, 256), 2.0 * bit - 1.0))


def test_onchip_cpu_takes_the_plain_version():
    w, _ = _weights(40, 8, 1, torch.float32)
    before = binarize_pack.launches, binarize_pack.launches_on_chip
    got = binarize_pack(w, stochastic=True, seed=4, on_chip_prng=True)
    assert torch.equal(got, binarize_pack_plain(w, None, stochastic=True, seed=4,
                                                on_chip_prng=True))
    assert (binarize_pack.launches, binarize_pack.launches_on_chip) == before


@pytest.mark.parametrize("kwargs,match", [
    (dict(stochastic=True, on_chip_prng=True), "seed"),
    (dict(bits=torch.zeros(64, 8, dtype=torch.int32), stochastic=True, seed=1,
          on_chip_prng=True), "bits"),
    (dict(stochastic=False, seed=1, on_chip_prng=True), "stochastic"),
    (dict(bits=torch.zeros(64, 8, dtype=torch.int32), stochastic=True, seed=1), "seed"),
])
def test_onchip_wrapper_checks_its_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        binarize_pack(torch.zeros(64, 8), **kwargs)
