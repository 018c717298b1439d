"""Geometry, weight layout, border correction and byte counts of the XNOR
conv engine (a copy of the reference's ``xnor/conv/packing.py`` in torch).

A (B, H, W, C) NHWC activation convolved with a (kh, kw, C, N) HWIO kernel
is a (B*OH*OW, K) x (K, N) matmul with K = kh*kw*C. Word layout
("per-tap"): the contraction axis flattens in (kh, kw, C) order and each
tap's C channels are padded on their own up to whole words
(``cw = ceil(C/32)``), so tap t owns words ``[t*cw, (t+1)*cw)``. The channel
pad bits are 0 on both operands, so they cancel in ``K - 2*popcount``.

Zero-padded border pixels do not cancel: their activation bit is 0 (= -1)
where dense zero-padded convolution counts 0. The exact fix is additive:

    dot_true[(i, j), n] = dot_raw[(i, j), n] + sum_{t padded at (i, j)} wsum[t, n],
    wsum[t, n] = sum_c sign(w)[t, c, n] = 2 * popcount(tap t words) - C.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.packing import PACK
from repro_torch.kernels import ops as kops
from repro_torch.xnor.packing import popcount


def conv_geometry(h: int, w: int, ksize, stride, padding):
    """Static conv geometry, XLA semantics: (oh, ow, ((ph0, ph1), (pw0, pw1)))."""
    kh, kw = ksize
    sh, sw = stride
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        pth = max((oh - 1) * sh + kh - h, 0)
        ptw = max((ow - 1) * sw + kw - w, 0)
        pads = ((pth // 2, pth - pth // 2), (ptw // 2, ptw - ptw // 2))
    elif padding == "VALID":
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        pads = ((0, 0), (0, 0))
    else:
        (ph0, ph1), (pw0, pw1) = padding
        oh = (h + ph0 + ph1 - kh) // sh + 1
        ow = (w + pw0 + pw1 - kw) // sw + 1
        pads = ((ph0, ph1), (pw0, pw1))
    if oh < 1 or ow < 1:
        raise ValueError(f"empty conv output for {(h, w)} k={ksize} s={stride}")
    return oh, ow, pads


def tap_words(c: int) -> int:
    """int32 words per spatial tap (channels padded to a word boundary)."""
    return (c + PACK - 1) // PACK


def patch_words(ksize, c: int) -> int:
    """Packed words per im2col patch row: kh*kw*ceil(C/32)."""
    return ksize[0] * ksize[1] * tap_words(c)


def conv_k(ksize, c: int) -> int:
    """True contraction length kh*kw*C (the K in ``K - 2*popcount``)."""
    return ksize[0] * ksize[1] * c


def pack_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """Eq.-1 binarize + bitpack a (kh, kw, C, N) kernel to (kh*kw*cw, N)
    int32 in the per-tap word layout (channel pad bits 0, i.e. -1), through
    the K1 kernel."""
    kh, kw, c, n = w.shape
    wp = F.pad(w, (0, 0, 0, tap_words(c) * PACK - c), value=-1.0)
    return kops.binarize_and_pack(wp.reshape(kh * kw * tap_words(c) * PACK, n))


def kernel_tap_sums(w_packed: torch.Tensor, ksize, c: int) -> torch.Tensor:
    """(kh*kw, N) int32: sum_c sign(w)[tap, c, n], read off the packed words.
    The channel pad bits are 0, so the -1 count uses the true C."""
    words = w_packed.reshape(ksize[0] * ksize[1], tap_words(c), -1)
    return 2 * popcount(words).sum(dim=1, dtype=torch.int32) - c


def padding_mask(h: int, w: int, ksize, stride, padding) -> np.ndarray:
    """(OH*OW, kh*kw) int32: 1 where tap (dy, dx) of output pixel (i, j)
    reads a spatially zero-padded input position (static, numpy)."""
    kh, kw = ksize
    sh, sw = stride
    oh, ow, ((ph0, _), (pw0, _)) = conv_geometry(h, w, ksize, stride, padding)
    rows = np.arange(oh)[:, None] * sh + np.arange(kh)[None, :] - ph0   # (OH, kh)
    cols = np.arange(ow)[:, None] * sw + np.arange(kw)[None, :] - pw0   # (OW, kw)
    row_bad = (rows < 0) | (rows >= h)
    col_bad = (cols < 0) | (cols >= w)
    mask = row_bad[:, None, :, None] | col_bad[None, :, None, :]
    return mask.reshape(oh * ow, kh * kw).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _mask_tensor(h: int, w: int, ksize, stride, padding, device) -> torch.Tensor | None:
    """:func:`padding_mask` on ``device``, copied there once per geometry
    (None when nothing is padded)."""
    mask = padding_mask(h, w, ksize, stride, padding)
    return torch.tensor(mask, device=device) if mask.any() else None


def border_correction(w_packed: torch.Tensor, h: int, w: int, ksize, stride,
                      padding, c: int) -> torch.Tensor | None:
    """(OH*OW, N) int32 to add to the raw popcount dot so zero-padded border
    taps contribute 0 instead of -sign(w). None when nothing is padded.
    Summed in int32 (an integer matmul has no CUDA kernel in torch)."""
    if not isinstance(padding, str):
        padding = tuple(tuple(p) for p in padding)
    mask = _mask_tensor(h, w, tuple(ksize), tuple(stride), padding, w_packed.device)
    if mask is None:
        return None
    sums = kernel_tap_sums(w_packed, ksize, c)
    return (mask[:, :, None] * sums[None]).sum(dim=1, dtype=torch.int32)


def conv_epilogue(dot: torch.Tensor, corr: torch.Tensor | None,
                  scale: torch.Tensor | None, out_dtype, b: int, oh: int, ow: int,
                  n: int) -> torch.Tensor:
    """Shared tail of the conv path and its oracle: add the border
    correction, apply the per-channel scale, resolve out_dtype (int32, or
    f32 when scaled), reshape (B*OH*OW, N) -> NHWC."""
    dot = dot.reshape(b, oh * ow, n)
    if corr is not None:
        dot = dot + corr[None]
    if out_dtype is None:
        out_dtype = torch.int32 if scale is None else torch.float32
    out = dot
    if scale is not None:
        out = dot.to(torch.float32) * scale.to(torch.float32)
    return out.to(out_dtype).reshape(b, oh, ow, n)


def patch_nbytes_dense(b: int, oh: int, ow: int, ksize, c: int,
                       dtype_bytes: int = 2) -> int:
    """Bytes of the dense im2col patch matrix (bf16 by default)."""
    return b * oh * ow * conv_k(ksize, c) * dtype_bytes


def patch_nbytes_packed(b: int, oh: int, ow: int, ksize, c: int) -> int:
    """Bytes of the bitpacked patch matrix (16x less for C % 32 == 0)."""
    return b * oh * ow * patch_words(ksize, c) * 4
