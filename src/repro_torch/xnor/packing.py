"""Bitpacking of binary activations along the contraction (last) axis.

``core.packing`` stores weights ``(K, N) -> (K // 32, N)``, packed along the
leading axis. Activations contract along their last axis, so here
``(M, K) -> (M, K // 32)``: bit ``b`` of word ``[m, j]`` holds the sign of
``x[m, 32 * j + b]`` (x >= ``core.binarize.SIGN_MIN`` -> 1, anything else,
subnormals included, -> 0, as Eq. 1).

Word ``a[m, j]`` and word ``w[j, n]`` then cover the same 32 contraction
positions, so the binary dot product is

    dot[m, n] = K - 2 * sum_j popcount(a[m, j] XOR w[j, n]).

Padding both sides with 0 bits cancels itself: padded positions XOR to 0,
and ``K`` is the true contraction length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import sign_bit
from repro_torch.core.packing import PACK, to_int32, to_uint32


def pad_features(x: torch.Tensor) -> torch.Tensor:
    """Pads the last axis up to a multiple of 32 with zeros (sign bit 0)."""
    rem = (-x.shape[-1]) % PACK
    return x if rem == 0 else F.pad(x, (0, rem))


def _shifts(device) -> torch.Tensor:
    return torch.arange(PACK, dtype=torch.int64, device=device)


def pack_activations(x: torch.Tensor) -> torch.Tensor:
    """Sign-binarizes and packs ``(..., K) -> (..., K // 32)`` int32. K must
    be a multiple of 32 (use :func:`pad_features` first for ragged K)."""
    k = x.shape[-1]
    if k % PACK != 0:
        raise ValueError(f"last dim {k} not a multiple of {PACK}; use pad_features")
    bits = sign_bit(x).to(torch.int64).reshape(x.shape[:-1] + (k // PACK, PACK))
    return to_int32((bits << _shifts(x.device)).sum(dim=-1))


def unpack_activations(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_activations`: ``(..., K // 32) -> (..., K)`` +-1."""
    bits = (to_uint32(words).unsqueeze(-1) >> _shifts(words.device)) & 1
    pm1 = torch.where(bits == 1, 1.0, -1.0).to(dtype)
    return pm1.reshape(words.shape[:-1] + (words.shape[-1] * PACK,))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 words (as their uint32 bit
    patterns), exact, as int32. torch has no popcount op, so this is the
    SWAR reduction over int64."""
    v = to_uint32(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def activation_nbytes(shape: tuple[int, ...], dtype_bytes: int = 2) -> int:
    """Bytes of a dense ``dtype_bytes``-wide activation tensor."""
    return math.prod(shape) * dtype_bytes


def packed_activation_nbytes(shape: tuple[int, ...]) -> int:
    """Bytes of the bitpacked form of a ``(..., K)`` activation tensor."""
    lead = math.prod(shape[:-1]) if len(shape) > 1 else 1
    return lead * ((shape[-1] + PACK - 1) // PACK) * 4
