"""A twin of the reference's ``jax.random`` key chain (threefry2x32), in torch.

The reference draws every stochastic weight word from ``jax.random`` with
jax's defaults: 32-bit keys (x64 off) and the partitionable threefry
(``jax_threefry_partitionable=True``), under which a word depends only on
the key and its row-major index in the drawn shape. These functions compute
the same words bit for bit, so a stochastic pack of the port at
``key(seed)`` equals the reference's at ``jax.random.key(seed)``:

* ``key(seed)``          -> (0, seed mod 2^32)
* ``fold_in(k, d)``      -> threefry2x32(k, (0, d mod 2^32))
* ``split(k, n)[i]``     -> threefry2x32(k, (i >> 32, i mod 2^32))
* ``bits(k, shape)[i]``  -> x0 ^ x1 of threefry2x32(k, (i >> 32, i mod 2^32)),
                            i the row-major flat index
* ``uniform(k, shape)``  -> f32 with mantissa bits >> 9 of ``bits``, minus 1
                            (then ``* (maxval - minval) + minval``, floored at
                            ``minval``)
* ``categorical(k, l)``  -> argmax(gumbel + l) over the last axis, the gumbel
                            draw ``-log(-log(uniform(k, l.shape, tiny, 1)))``
                            (jax's default "low" mode)

A key is a :class:`Key` of two Python ints, so key arithmetic never touches
a device. Words are computed on int64 tensors holding uint32 values, with
every add, rotate and xor masked to 32 bits. This is pack-time and
sampling-time work: the reference draws these words with plain
``jax.random`` calls outside any kernel, and plain torch on the leaf's (or
the logits') device is its counterpart. The uniform words are the
reference's bit for bit; the gumbel draw's two ``log`` calls may differ from
XLA's in the last ulp, so a categorical sample can differ only where the
top two of ``logits + gumbel`` are that close.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.packing import to_int32

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA        # Threefish key-schedule constant


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry2x32 key: two uint32 words, as ``jax.random.key_data`` holds them."""

    k0: int
    k1: int


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under
    ``key``; the words are Python ints or int64 tensors holding uint32
    values, and so are the two results."""
    ks = (key.k0, key.k1, key.k0 ^ key.k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` with 32-bit keys: (0, seed mod 2^32)."""
    return Key(0, int(seed) & _MASK32)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return Key(*threefry2x32(k, 0, int(data) & _MASK32))


def split(k: Key, n: int = 2) -> list[Key]:
    """``jax.random.split(k, n)`` (partitionable threefry)."""
    return [Key(*threefry2x32(k, i >> 32, i & _MASK32)) for i in range(n)]


def _words(k: Key, shape, device) -> torch.Tensor:
    """uint32 words of ``jax.random.bits(k, shape)``, held in int64."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k, i >> 32, i & _MASK32)
    return (x0 ^ x1).reshape(tuple(shape))


def bits(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int32 bit patterns."""
    return to_int32(_words(k, shape, device))


def uniform(k: Key, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the [0, 1)
    floats scaled as jax scales them, in f32."""
    mant = ((_words(k, shape, device) >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


TINY32 = torch.finfo(torch.float32).tiny


def gumbel(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(k, shape, float32)`` in its default "low" mode."""
    return -torch.log(-torch.log(uniform(k, shape, device, minval=TINY32, maxval=1.0)))


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis=-1)`` for f32 ``logits``:
    int32 indices of the Gumbel-max sample over the last axis (the first
    index where two are equal, as ``jnp.argmax``)."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes f32 logits, got {logits.dtype}")
    g = gumbel(k, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)
