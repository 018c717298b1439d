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
* ``uniform(k, shape)``  -> f32 with mantissa (uint32) bits >> 9 of ``bits``, minus 1
                            (then ``* (maxval - minval) + minval``, floored at
                            ``minval``)
* ``categorical(k, l)``  -> argmax(gumbel + l) over the last axis, the gumbel
                            draw ``-log(-log(uniform(k, l.shape, tiny, 1)))``
                            (jax's default "low" mode)

A key is a :class:`Key` of two Python ints, so key arithmetic never touches
a device. Words are computed a chunk of indices at a time (``WORDS_CHUNK``):
on the CPU in numpy uint32, whose adds wrap; on a card as int64 tensors
holding uint32 values, masked to 32 bits where a rotate needs it. This is
pack-time and
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

import numpy as np
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
    values, and so are the two results. Key arithmetic calls it on ints;
    :func:`bits` runs the same rounds in place, a chunk at a time."""
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


# Flat indices a pass of :func:`bits` computes at once. On the CPU the
# rounds run in numpy uint32 (wrapping adds, logical shifts, one thread) over
# three buffers that stay in a core's cache: torch's int64 ops over a whole
# leaf are slower, and far slower when several processes share the CPU,
# each op then waiting on a barrier of torch's thread pool. On the card a
# pass launches ~135 elementwise torch kernels over int64, so its chunk
# holds a whole 2048 x 2048 leaf.
WORDS_CHUNK = {"cpu": 1 << 16, "cuda": 1 << 22}


def _host_words(k: Key, n: int) -> np.ndarray:
    """The first ``n`` words of ``bits(k, ...)`` as uint32, on the host: the
    rounds of :func:`threefry2x32`, a chunk at a time, in place on two
    counter buffers and one rotate temporary, into a preallocated output."""
    chunk = WORDS_CHUNK["cpu"]
    ks = [np.uint32(v) for v in (k.k0, k.k1, k.k0 ^ k.k1 ^ _PARITY)]
    out = np.empty(n, np.uint32)
    buf = np.empty((3, min(chunk, n)), np.uint32)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        x0, x1, t = buf[0, :m], buf[1, :m], buf[2, :m]
        i = np.arange(start, start + m, dtype=np.uint64)
        x0[:] = i >> np.uint64(32)
        x1[:] = i & np.uint64(_MASK32)
        x0 += ks[0]
        x1 += ks[1]
        for r5 in range(5):
            for r in _ROTATIONS[r5 % 2]:
                x0 += x1
                np.right_shift(x1, np.uint32(32 - r), out=t)
                np.left_shift(x1, np.uint32(r), out=x1)
                x1 |= t
                x1 ^= x0
            x0 += ks[(r5 + 1) % 3]
            x1 += np.uint32((int(ks[(r5 + 2) % 3]) + r5 + 1) & _MASK32)
        np.bitwise_xor(x0, x1, out=out[start:start + m])
    return out


def _device_words(k: Key, n: int, device) -> torch.Tensor:
    """The same words on ``device``, in int64 holding uint32 values: the
    rounds a chunk at a time, in place. Only ``x1`` is masked to 32 bits
    (before each rotate); ``x0`` carries its carries above bit 31, which
    never reach the low 32 bits of a sum or an xor, and stays below 2^38."""
    chunk = WORDS_CHUNK[device.type]
    ks = (k.k0, k.k1, k.k0 ^ k.k1 ^ _PARITY)
    out = torch.empty(n, dtype=torch.int64, device=device)
    buf = torch.empty((3, min(chunk, n)), dtype=torch.int64, device=device)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        x0, x1, t = buf[0, :m], buf[1, :m], buf[2, :m]
        torch.arange(start, start + m, out=x1)
        torch.bitwise_right_shift(x1, 32, out=x0)
        x0.add_(ks[0])
        x1.bitwise_and_(_MASK32).add_(ks[1]).bitwise_and_(_MASK32)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0.add_(x1)
                torch.bitwise_right_shift(x1, 32 - r, out=t)
                x1.bitwise_left_shift_(r).bitwise_or_(t).bitwise_xor_(x0).bitwise_and_(_MASK32)
            x0.add_(ks[(i + 1) % 3])
            x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK32)
        torch.bitwise_xor(x0, x1, out=out[start:start + m]).bitwise_and_(_MASK32)
    return out


def bits(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int32 bit patterns, on
    ``device`` (the CPU when None)."""
    n = math.prod(shape)
    device = torch.device("cpu" if device is None else device)
    if device.type == "cpu":
        words = torch.from_numpy(_host_words(k, n).view(np.int32))
    else:
        words = to_int32(_device_words(k, n, device))
    return words.reshape(tuple(shape))


def uniform(k: Key, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the [0, 1)
    floats scaled as jax scales them, in f32."""
    mant = ((bits(k, shape, device) >> 9) & 0x7FFFFF) | 0x3F800000
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
