"""Public wrappers of the XNOR conv engine: ``sign_and_pack_patches`` (K5)
and ``xnor_conv2d``, which lowers a binary convolution onto the K4 popcount
matmul with the exact zero-padding border correction and the epilogue.

On CUDA tensors the correction and the epilogue are K4's flush: the layer
is K5, K4 and a view to NHWC, and the correction reads the per-tap weight
sums the ``XnorConv`` leaf computed once at pack time. On CPU tensors the
route is the reference's (the plain K5 and K4, then the correction table
and the epilogue in plain torch), which is the fused path's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.xnor import ops as xops
from repro_torch.xnor.conv.kernel import patch_pack
from repro_torch.xnor.conv.packing import (border_correction, conv_epilogue,
                                           conv_geometry, conv_k, kernel_tap_sums,
                                           patch_words)
from repro_torch.xnor.kernel import ConvBorder


def sign_and_pack_patches(x: torch.Tensor, *, ksize, stride=(1, 1),
                          padding="SAME") -> torch.Tensor:
    """Fused sign-binarize + bitpack of im2col patches:
    (B, H, W, C) -> (B, OH, OW, kh*kw*ceil(C/32)) int32. Spatial zero padding
    and per-tap channel padding both carry sign bit 0."""
    return patch_pack(x.contiguous(), ksize=tuple(ksize), stride=tuple(stride),
                      padding=padding)


def xnor_conv2d(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor | None = None, *, ksize, c_in: int,
                stride=(1, 1), padding="SAME", out_dtype=None,
                tap_sums: torch.Tensor | None = None) -> torch.Tensor:
    """Fully-binary 2-D convolution, NHWC x (packed HWIO) -> NHWC.

    ``w_packed`` is a ``pack_conv_kernel``-layout (kh*kw*ceil(c_in/32), N)
    int32 weight. Exactly ``conv(sign(x), sign(w))`` with zero padding
    (border pixels contribute 0, not -1), optionally times a per-channel
    ``scale``. ``out_dtype`` defaults to int32, or f32 when scaled.
    ``tap_sums`` is ``kernel_tap_sums(w_packed, ksize, c_in)``, which the
    ``XnorConv`` leaf holds; it is computed here when not given."""
    ksize, stride = tuple(ksize), tuple(stride)
    b, h, w, c = x.shape
    if c != c_in:
        raise ValueError(f"x has C={c}, packed kernel expects C={c_in}")
    if w_packed.shape[0] != patch_words(ksize, c_in):
        raise ValueError(f"w_packed has {w_packed.shape[0]} words, layout needs "
                         f"{patch_words(ksize, c_in)} (k={ksize}, C={c_in})")
    n = w_packed.shape[-1]
    oh, ow, ((ph0, _), (pw0, _)) = conv_geometry(h, w, ksize, stride, padding)
    a = sign_and_pack_patches(x, ksize=ksize, stride=stride, padding=padding)
    a = a.reshape(b * oh * ow, -1)
    if a.device.type == "cpu":
        dot = xops.xnor_matmul_packed(a, w_packed, None, k=conv_k(ksize, c_in),
                                      allow_extra_words=True)
        corr = border_correction(w_packed, h, w, ksize, stride, padding, c_in)
        return conv_epilogue(dot, corr, scale, out_dtype, b, oh, ow, n)
    if tap_sums is None:
        tap_sums = kernel_tap_sums(w_packed, ksize, c_in)
    border = ConvBorder(tap_sums, h, w, oh, ow, ksize, stride, (ph0, pw0))
    out = xops.xnor_matmul_packed(a, w_packed, scale, k=conv_k(ksize, c_in),
                                  out_dtype=out_dtype, allow_extra_words=True,
                                  border=border)
    return out.view(b, oh, ow, n)
