"""K1's threefry mode against the reference's stochastic pack, bit for bit.

``binarize_pack(w, key=k, draw_cols=d, stochastic=True)`` thresholds word
(r, c) of ``jax.random.bits(k, (., d))``: on a card the kernel computes the
word in its loop, and its plain version (the one a CPU tensor takes) is the
operand rule fed ``prng.bits(k, (K, d))[:, :N]``. ``kernels.ops.
binarize_and_pack`` routes every stochastic pack there, with d the columns
of the shape the reference draws over: N on its tiny cut, the 256-padded
columns otherwise. Both must give the words of the reference's
``repro.kernels.ops.binarize_and_pack(w, key, stochastic=True)`` at the
keys the plan's backends pass: ``split(fold_in(key, i), L)[l]`` for a
stacked linear leaf, ``fold_in(key, i)`` for a packed conv. The card's side
of the mode is held against these plain versions in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.kernels import ops as jops
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.stoch_binarize import (binarize_pack, binarize_pack_plain,
                                                threefry_words)

# (K, N, the reference's draw columns): K < 32, K % 32 != 0 and N % 32 != 0
# on its tiny cut (words over the 32-padded (Kp, N)), then its 256-padded
# draw, wider than the leaf, with both dims ragged and with neither
SHAPES = [(5, 7, 7), (31, 40, 40), (33, 7, 7), (100, 300, 300),
          (200, 230, 256), (288, 288, 512), (512, 96, 256)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (seed, leaf index, matrices in the leaf, matrix): the key of matrix l of a
# stacked linear leaf, split(fold_in(key(seed), i), L)[l]; L = None: a packed
# conv's fold_in(key(seed), i)
KEYS = [(0, 3, 4, 2), (7, 11, None, None)]


def _keys(seed, index, count, which):
    k, jk = prng.fold_in(prng.key(seed), index), jax.random.fold_in(jax.random.key(seed), index)
    if count is None:
        return k, jk
    return prng.split(k, count)[which], jax.random.split(jk, count)[which]


def _weights(k, n, dtype):
    """Masters with the clip endpoints (+-1, beyond them, 0) planted."""
    w = np.random.default_rng(k * 1000 + n).normal(0.0, 0.7, (k, n)).astype(np.float32)
    w[0, : min(n, 4)] = [1.0, -1.0, 1.5, -0.0][: min(n, 4)]
    return torch.from_numpy(w).to(DTYPES[dtype][0]), jnp.asarray(w).astype(DTYPES[dtype][1])


@pytest.mark.parametrize("key_case", KEYS, ids=["split_fold_in", "fold_in"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,draw_cols", SHAPES)
def test_threefry_mode_equals_reference_pack(k, n, draw_cols, dtype, key_case):
    assert ops.draw_cols(k, n) == draw_cols
    w, jw = _weights(k, n, dtype)
    key, jkey = _keys(*key_case)
    want = np.asarray(jops.binarize_and_pack(jw, jkey, stochastic=True))
    plain = binarize_pack_plain(w, prng.bits(key, (k, draw_cols))[:, :n], stochastic=True)
    np.testing.assert_array_equal(plain.numpy(), want)
    before = binarize_pack.launches, binarize_pack.launches_threefry
    got = binarize_pack(w, key=key, draw_cols=draw_cols, stochastic=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.binarize_and_pack(w, key, stochastic=True).numpy(), want)
    assert (binarize_pack.launches, binarize_pack.launches_threefry) == before


def test_threefry_words_are_the_draws_row_major_words():
    """Word (r, c) is the draw's flat word r * draw_cols + c, whatever the
    draw's row count."""
    key = prng.fold_in(prng.key(5), 2)
    flat = prng.bits(key, (40 * 96,))
    np.testing.assert_array_equal(threefry_words(key, 40, 70, 96).numpy(),
                                  flat.reshape(40, 96)[:, :70].numpy())
    np.testing.assert_array_equal(threefry_words(key, 40, 96, 96).numpy(),
                                  flat.reshape(40, 96).numpy())


def test_draw_cols_defaults_to_n():
    w, _ = _weights(40, 24, "f32")
    key = prng.key(9)
    assert torch.equal(binarize_pack(w, key=key, stochastic=True),
                       binarize_pack(w, key=key, draw_cols=24, stochastic=True))


@pytest.mark.parametrize("kwargs,match", [
    (dict(bits=torch.zeros(64, 8, dtype=torch.int32), key=prng.key(1), stochastic=True),
     "exactly one"),
    (dict(key=prng.key(1), stochastic=True, seed=1, on_chip_prng=True), "exactly one"),
    (dict(key=prng.key(1), stochastic=False), "stochastic=False"),
    (dict(key=prng.key(1), draw_cols=7, stochastic=True), "at least N"),
    (dict(bits=torch.zeros(64, 8, dtype=torch.int32), draw_cols=8, stochastic=True),
     "draw_cols goes with a key"),
])
def test_threefry_wrapper_refuses(kwargs, match):
    with pytest.raises(ValueError, match=match):
        binarize_pack(torch.zeros(64, 8), **kwargs)
