"""Bitpacking of binary {-1,+1} tensors into int32 words.

A binarized weight of shape (K, N) is stored as one sign bit per weight
(+1 -> 1, -1 -> 0), 32 weights per int32 word along the leading
(contraction) axis: the packed form is (K // 32, N) int32 and bit ``b`` of
word ``[k32, n]`` holds the sign of ``w[32 * k32 + b, n]``. Bit 31 is the
int32 sign bit, so words are built in int64 and wrapped to int32 at the
end; a column of 32 positive weights packs to the word -1.
"""
from __future__ import annotations

import math

import torch

PACK = 32
_TWO31 = 1 << 31
_TWO32 = 1 << 32


def _shifts(ndim: int, device) -> torch.Tensor:
    return torch.arange(PACK, dtype=torch.int64, device=device).reshape(
        (1, PACK) + (1,) * (ndim - 1))


def pad_to_pack(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pads ``axis`` up to a multiple of 32 with -1 entries (bit 0)."""
    rem = (-w.shape[axis]) % PACK
    if rem == 0:
        return w
    pad_shape = list(w.shape)
    pad_shape[axis] = rem
    pad = torch.full(pad_shape, -1.0, dtype=w.dtype, device=w.device)
    return torch.cat([w, pad], dim=axis)


def pack_bits(w_pm1: torch.Tensor) -> torch.Tensor:
    """Packs a tensor of shape (K, ...) into (K // 32, ...) int32.

    ``x > 0`` gives bit 1, anything else (-1, 0, -0.0, NaN) bit 0 (Eq. 1)."""
    k = w_pm1.shape[0]
    if k % PACK != 0:
        raise ValueError(f"leading dim {k} not a multiple of {PACK}; use pad_to_pack")
    bits = (w_pm1 > 0).to(torch.int64)
    bits = bits.reshape((k // PACK, PACK) + tuple(w_pm1.shape[1:]))
    words = (bits << _shifts(w_pm1.ndim, w_pm1.device)).sum(dim=1)
    return to_int32(words)


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """Reinterprets uint32 values held in int64 as int32 bit patterns."""
    return torch.where(words >= _TWO31, words - _TWO32, words).to(torch.int32)


def to_uint32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, held in int64."""
    return words.to(torch.int64) & (_TWO32 - 1)


def unpack_bits(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (K // 32, ...) int32 -> (K, ...) +-1."""
    w = to_uint32(words)
    bits = (w.unsqueeze(1) >> _shifts(w.ndim, w.device)) & 1
    pm1 = torch.where(bits == 1, 1.0, -1.0).to(dtype)
    return pm1.reshape((w.shape[0] * PACK,) + tuple(w.shape[1:]))


def packed_nbytes(shape: tuple[int, ...]) -> int:
    """Bytes of the packed representation of a (K, N, ...) weight."""
    rest = math.prod(shape[1:]) if len(shape) > 1 else 1
    return ((shape[0] + PACK - 1) // PACK) * rest * 4


def compression_ratio(shape: tuple[int, ...], dtype_bytes: int = 2) -> float:
    """Weight-bytes compression against a dense tensor of ``dtype_bytes``-wide
    values."""
    return math.prod(shape) * dtype_bytes / packed_nbytes(shape)
