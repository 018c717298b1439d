"""Plain torch versions of every CUDA kernel (the correctness ground truth).

Straight-line tensor code with no blocking. The kernel wrappers run these
for tensors on the CPU; tests and ``chip_smoke.py`` hold the kernels
against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.binarize import deterministic_binarize

_TWO32 = 4294967296.0


def binary_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor | None = None, *,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """out = x @ unpack(w_packed)[:K] [* scale], f32. ``x`` is rounded to
    ``compute_dtype`` first; products with +-1 are exact, so the sum is
    taken in f32 whatever the compute dtype."""
    k = x.shape[-1]
    w = packing.unpack_bits(w_packed, dtype=torch.float32)[:k]
    out = x.to(compute_dtype).to(torch.float32) @ w
    if scale is not None:
        out = out * scale.to(torch.float32)[None, :]
    return out


def binary_matmul_batched_ref(x: torch.Tensor, w_packed: torch.Tensor,
                              scale: torch.Tensor | None = None,
                              rows: torch.Tensor | None = None, *,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """:func:`binary_matmul_ref` for each of E experts: x (E, M, K) @
    unpack(w_packed (E, K/32, N))[:, :K] [* scale (E, N)] -> (E, M, N) f32.
    With ``rows`` (E,), expert e's output rows from ``rows[e]`` on are +0
    [* scale], what the product gives on the zero rows an MoE dispatch
    buffer holds there."""
    k = x.shape[-1]
    w = packing.unpack_bits(w_packed.movedim(0, 1), dtype=torch.float32)[:k].movedim(1, 0)
    out = torch.matmul(x.to(compute_dtype).to(torch.float32), w)
    if rows is not None:
        live = torch.arange(x.shape[1], device=x.device) < rows[:, None]     # (E, M)
        out = torch.where(live[:, :, None], out, 0.0)
    if scale is not None:
        out = out * scale.to(torch.float32)[:, None, :]
    return out


def det_binarize_pack_ref(w: torch.Tensor) -> torch.Tensor:
    """Sign-binarize (Eq. 1, ``core.binarize.SIGN_MIN``), then bitpack."""
    return packing.pack_bits(deterministic_binarize(w))


def stoch_binarize_pack_ref(w: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic binarize (Eq. 2-3) against supplied uniform words, then
    bitpack. ``bits`` holds uint32 words as int32 bit patterns.

    bit = (f32(u) < f32(p * 2^32)) | (p >= 1), p = clip((w + 1) / 2, 0, 1).
    The p = 1 endpoint is forced: words in the top 128 values round up to
    2^32 in f32 and would tie with the threshold."""
    p = torch.clamp((w.to(torch.float32) + 1.0) * 0.5, 0.0, 1.0)
    thresh = p * _TWO32
    u = packing.to_uint32(bits).to(torch.float32)
    ones = (u < thresh) | (p >= 1.0)
    return packing.pack_bits(torch.where(ones, 1.0, -1.0))
