"""Port parity: core packing, binarization and policy against the reference.

Inputs are made with numpy from a seed and handed to both packages; the
packed words must be equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core import binarize as jB
from repro.core import packing as jP
from repro.core import policy as jpol
from repro.kernels import ref as jref
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro_torch.core import binarize as B
from repro_torch.core import packing as P
from repro_torch.core import policy as pol
from repro_torch.core import prng
from repro_torch.kernels.stoch_binarize import binarize_pack_plain


def _special_weights(k, n, seed):
    """Normal weights with the hazards planted: +-1 endpoints, -0.0, NaN,
    +-inf and an all-positive column."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.8, (k, n)).astype(np.float32)
    flat = w.reshape(-1)
    idx = rng.choice(flat.size, size=min(flat.size, 6 * 8), replace=False)
    flat[idx] = np.resize(np.array([1.0, -1.0, -0.0, np.nan, np.inf, -np.inf],
                                   np.float32), len(idx))
    w[:, 0] = np.abs(w[:, 0]) + 0.5
    return w


@pytest.mark.parametrize("k,n", [(32, 1), (64, 7), (96, 33), (256, 128)])
def test_pack_bits_matches_reference(k, n):
    w = _special_weights(k, n, k * n)
    got = P.pack_bits(torch.from_numpy(w))
    want = np.asarray(jP.pack_bits(jnp.asarray(w)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", [(33, 4), (100, 9), (1, 3), (64, 2)])
def test_pad_to_pack_matches_reference(k, n):
    w = _special_weights(k, n, k + n)
    got = P.pad_to_pack(torch.from_numpy(w))
    want = np.asarray(jP.pad_to_pack(jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.pack_bits(got).numpy(),
                                  np.asarray(jP.pack_bits(jnp.asarray(want))))


@pytest.mark.parametrize("k32,n", [(1, 1), (3, 17), (8, 64)])
def test_unpack_bits_matches_reference(k32, n):
    rng = np.random.default_rng(k32 * 31 + n)
    words = rng.integers(-2**31, 2**31, (k32, n), dtype=np.int64).astype(np.int32)
    words[0, 0] = -1                       # all 32 bits set, sign bit included
    got = P.unpack_bits(torch.from_numpy(words))
    want = np.asarray(jP.unpack_bits(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.pack_bits(got).numpy(), words)


@pytest.mark.parametrize("shape", [(2048, 2048), (784, 2048), (33, 5), (7,)])
def test_packed_nbytes_matches_reference(shape):
    assert P.packed_nbytes(shape) == jP.packed_nbytes(shape)


class TestSignWordAndEndpoint:
    """The two places a port most easily drifts from the reference bit for
    bit: bit 31 is the int32 sign bit, and p >= 1 must give bit 1 for every
    uniform word, the top 128 words included."""

    def _top_words(self, k, n):
        top = (2**32 - 1 - np.arange(k * n) % 128).astype(np.uint32).reshape(k, n)
        return top, torch.from_numpy(top.view(np.int32))

    def test_all_positive_column_packs_to_minus_one(self):
        w = np.abs(_special_weights(64, 5, 0)) + 0.1
        w[np.isnan(w)] = 1.0
        want = np.asarray(jP.pack_bits(jnp.asarray(w)))
        assert (want == -1).all()
        np.testing.assert_array_equal(P.pack_bits(torch.from_numpy(w)).numpy(), want)
        np.testing.assert_array_equal(
            binarize_pack_plain(torch.from_numpy(w), None, stochastic=False).numpy(), want)

    def test_p_one_endpoint_with_top_words(self):
        w = np.ones((64, 6), np.float32)
        w[:, 3:] = 1.5                               # clipped to p = 1 as well
        top_u32, top_i32 = self._top_words(64, 6)
        want = np.asarray(jref.stoch_binarize_pack_ref(jnp.asarray(w),
                                                       jnp.asarray(top_u32)))
        assert (want == -1).all()
        got = binarize_pack_plain(torch.from_numpy(w), top_i32, stochastic=True)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_p_zero_endpoint_with_zero_words(self):
        w = -np.ones((32, 3), np.float32)
        bits = torch.zeros(32, 3, dtype=torch.int32)
        got = binarize_pack_plain(torch.from_numpy(w), bits, stochastic=True)
        assert (got == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deterministic_binarize_matches_reference(seed):
    w = _special_weights(64, 16, seed)
    got = B.deterministic_binarize(torch.from_numpy(w))
    want = np.asarray(jB.deterministic_binarize(jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(got.numpy())) <= {-1.0, 1.0}


def test_hard_sigmoid_and_clip_match_reference():
    x = np.linspace(-3, 3, 97, dtype=np.float32)
    np.testing.assert_array_equal(B.hard_sigmoid(torch.from_numpy(x)).numpy(),
                                  np.asarray(jB.hard_sigmoid(jnp.asarray(x))))
    np.testing.assert_array_equal(B.clip_weights(torch.from_numpy(x)).numpy(),
                                  np.asarray(jB.clip_weights(jnp.asarray(x))))


@pytest.mark.parametrize("wval,p", [(-0.6, 0.2), (0.0, 0.5), (0.5, 0.75),
                                    (-1.0, 0.0), (1.0, 1.0)])
def test_stochastic_binarize_frequency(wval, p):
    """Eq. 2-3: P(+1) = hard_sigmoid(w); 4-sigma band over 256x256 draws."""
    out = B.stochastic_binarize(torch.full((256, 256), wval), prng.key(int(wval * 100) + 7))
    frac = float((out > 0).float().mean())
    assert abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / out.numel()) + 1e-9


@pytest.mark.parametrize("value", ["det", "stoch", "none", None, "DETERMINISTIC",
                                   "stochastic"])
def test_binarize_mode_parse_matches_reference(value):
    assert B.BinarizeMode.parse(value).value == jB.BinarizeMode.parse(value).value


_PATHS = ["layers/0/kernel", "layers/1/kernel", "layers/2/kernel", "layers/3/kernel",
          "layers/1/bias", "layers/1/bn_scale", "layers/1/bn_bias", "fc/0/kernel",
          "conv/0/kernel", "conv/3/kernel", "embed/table", "attn/w_qkv",
          "blocks/0/norm/scale", "router/kernel", "lm_head/kernel", "mlp/wi"]


@pytest.mark.parametrize("n_fc", [3, 4])
def test_policies_match_reference(n_fc):
    pairs = [(pol.DEFAULT_POLICY, jpol.DEFAULT_POLICY),
             (pol.NONE_POLICY, jpol.NONE_POLICY),
             (pol.make_paper_policy(n_fc), j_make_paper_policy(n_fc))]
    for port, jax_pol in pairs:
        for path in _PATHS:
            assert port.selects(path) == jax_pol.selects(path), path
            assert port.excluded_by(path) == jax_pol.excluded_by(path), path
    for path in _PATHS:
        assert pol.is_conv_kernel(path) == jpol.is_conv_kernel(path)
