"""Public wrappers around K3 (with and without its batch-norm prologue),
the unpacked prologue-and-sign kernel, and K4: leading-dim flattening and the word-count checks of the
reference's ``xnor/ops.py``.

Unlike the reference, nothing here pads to blocks or cuts tiny shapes over
to the plain version: the kernels mask ragged edges, and the wrappers take
the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PACK
from repro_torch.xnor.kernel import ConvBorder
from repro_torch.xnor.kernel import bn_sign as _bn_sign
from repro_torch.xnor.kernel import bn_sign_pack as _bn_sign_pack
from repro_torch.xnor.kernel import sign_pack as _sign_pack
from repro_torch.xnor.kernel import xnor_matmul as _xnor_matmul


def sign_and_pack(x: torch.Tensor) -> torch.Tensor:
    """Fused sign-binarize (Eq. 1) + bitpack: ``(..., K) -> (..., ceil(K/32))``."""
    *lead, k = x.shape
    out = _sign_pack(x.reshape(-1, k).contiguous())
    return out.reshape(*lead, out.shape[-1])


def bn_sign_and_pack(h: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
                     bn_bias: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor) -> torch.Tensor:
    """Eq.-1 sign of eval ``batch_norm(h + bias, ...)`` + bitpack, in one K3
    launch: ``(..., K) -> (..., ceil(K/32))``; the vectors are (K,)."""
    *lead, k = h.shape
    out = _bn_sign_pack(h.reshape(-1, k).contiguous(),
                        *(v.contiguous() for v in (bias, bn_scale, bn_bias, mean, var)))
    return out.reshape(*lead, out.shape[-1])


def bn_sign(h: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
            bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Eq.-1 sign (+-1 f32) of eval ``batch_norm(h + bias, ...)`` in one
    launch: ``(..., K) -> (..., K)``; the vectors are (K,)."""
    *lead, k = h.shape
    out = _bn_sign(h.reshape(-1, k).contiguous(),
                   *(v.contiguous() for v in (bias, bn_scale, bn_bias, mean, var)))
    return out.reshape(*lead, k)


def xnor_matmul_packed(a_packed: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor | None = None, *, k: int, out_dtype=None,
                       allow_extra_words: bool = False,
                       border: ConvBorder | None = None) -> torch.Tensor:
    """Popcount matmul over packed operands: a (..., K32), w (K32, N).

    ``k`` is the true contraction length. ``allow_extra_words`` permits
    K32 > ceil(k/32), for layouts whose surplus positions are 0 bits on both
    sides (the conv engine's per-tap channel padding); without it a
    word-count mismatch is a caller bug. ``border`` (the conv path's) has K4
    add the zero-padding border correction before the scale. ``out_dtype``
    defaults to int32, or f32 when a scale is applied."""
    *lead, k32 = a_packed.shape
    k32w, n = w_packed.shape
    if k32 != k32w:
        raise ValueError(f"packed K mismatch: a has {k32} words, w has {k32w}")
    needed = (k + PACK - 1) // PACK
    if (k32 < needed) if allow_extra_words else (k32 != needed):
        raise ValueError(f"k={k} inconsistent with {k32} packed words")
    out = _xnor_matmul(a_packed.reshape(-1, k32).contiguous(), w_packed.contiguous(),
                       None if scale is None else scale.to(torch.float32).contiguous(),
                       k_total=k, border=border)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.reshape(*lead, n)


def xnor_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor | None = None, *, k: int | None = None,
                out_dtype=None) -> torch.Tensor:
    """Fully-binary linear: sign-pack ``x`` (..., K), then popcount matmul
    against a ``core.packing``-layout (ceil(K/32), N) weight. Exactly
    ``sign(x) @ sign(w)`` [* scale]."""
    kdim = k if k is not None else x.shape[-1]
    if x.shape[-1] != kdim:
        raise ValueError(f"x K={x.shape[-1]} != declared k={kdim}")
    return xnor_matmul_packed(sign_and_pack(x), w_packed, scale, k=kdim,
                              out_dtype=out_dtype)
