"""Plain torch versions of the XNOR conv engine (exact integer ground
truth), mirroring the reference's ``xnor/conv/ref.py``:

  * ``xnor_conv2d_ref`` -- packed im2col patches -> popcount GEMM -> border
    correction (what the kernel path computes),
  * ``sign_conv_ref``   -- ``conv(sign(x), sign(w))`` with zero padding in
    f32 (the semantic spec: padded border pixels contribute 0).

Every interface is NHWC/HWIO, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import deterministic_binarize
from repro_torch.core.packing import PACK
from repro_torch.models.layers import conv2d_nhwc
from repro_torch.xnor import packing as apack
from repro_torch.xnor import ref as xref
from repro_torch.xnor.conv.packing import (border_correction, conv_epilogue,
                                           conv_geometry, conv_k, tap_words)


def conv_patches_ref(x: torch.Tensor, ksize, stride=(1, 1), padding="SAME") -> torch.Tensor:
    """Zero-filled im2col: (B, H, W, C) -> (B, OH, OW, kh*kw*C), taps in
    (kh, kw, C) order (the layout ``pack_conv_kernel`` flattens to)."""
    _, h, w, _ = x.shape
    kh, kw = ksize
    sh, sw = stride
    oh, ow, ((ph0, ph1), (pw0, pw1)) = conv_geometry(h, w, ksize, stride, padding)
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    taps = [xp[:, dy:dy + (oh - 1) * sh + 1:sh, dx:dx + (ow - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(taps, dim=-1)


def sign_pack_patches_ref(x: torch.Tensor, ksize, stride=(1, 1),
                          padding="SAME") -> torch.Tensor:
    """Sign-binarize + bitpack patches in the per-tap word layout:
    (B, H, W, C) -> (B, OH, OW, kh*kw*ceil(C/32)) int32. Spatial zero pad
    and channel pad both carry sign bit 0."""
    c = x.shape[-1]
    kh, kw = ksize
    p = conv_patches_ref(x, ksize, stride, padding)
    b, oh, ow, _ = p.shape
    p = F.pad(p.reshape(b, oh, ow, kh * kw, c), (0, tap_words(c) * PACK - c))
    return apack.pack_activations(p.reshape(b, oh, ow, kh * kw * tap_words(c) * PACK))


def xnor_conv2d_ref(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor | None = None, *, ksize, c_in: int,
                    stride=(1, 1), padding="SAME", out_dtype=None) -> torch.Tensor:
    """End-to-end oracle: packed patches -> ``K - 2*popcount(xor)`` GEMM ->
    border correction [-> per-channel scale]."""
    b, h, w, _ = x.shape
    oh, ow, _ = conv_geometry(h, w, ksize, stride, padding)
    n = w_packed.shape[-1]
    a = sign_pack_patches_ref(x, ksize, stride, padding)
    dot = xref.xnor_matmul_ref(a.reshape(b * oh * ow, -1), w_packed, conv_k(ksize, c_in))
    corr = border_correction(w_packed, h, w, ksize, stride, padding, c_in)
    return conv_epilogue(dot, corr, scale, out_dtype, b, oh, ow, n)


def sign_conv_ref(x: torch.Tensor, w: torch.Tensor, stride=(1, 1),
                  padding="SAME") -> torch.Tensor:
    """The semantic spec: ``conv(sign(x), sign(w))`` densely in f32, with
    signs taken before zero padding so border pixels contribute 0."""
    _, h, wd, _ = x.shape
    _, _, pads = conv_geometry(h, wd, w.shape[:2], stride, padding)
    xs = deterministic_binarize(x).to(torch.float32)
    ws = deterministic_binarize(w).to(torch.float32)
    return conv2d_nhwc(xs, ws, stride, pads)
