"""K3 and K4 wrappers: fused sign + bitpack of activations, and the
XNOR-popcount matmul over packed operands.

* ``sign_pack(x)``: (M, K) f32/bf16 -> (M, ceil(K/32)) int32, bit = Eq. 1
  (``csrc/sign_pack.cu``).
* ``bn_sign_pack(h, bias, bn_scale, bn_bias, mean, var)``: the same words
  for y = eval batch_norm(h + bias), with the bias, the batch norm and the
  sign computed in K3's load (its producer prologue), f32 only.
* ``bn_sign(h, bias, bn_scale, bn_bias, mean, var)``: the same prologue and
  sign as +-1 f32 of h's shape, unpacked (``bn_sign_kernel`` in
  ``csrc/sign_pack.cu``), for the sign sites whose consumer reads floats.
* ``xnor_matmul(a, w, scale, k_total=k, border=None)``: a (M, W) int32 x
  w (W, N) int32 -> ``k - 2 * popcount(a XOR w)`` as int32, or
  f32(dot) * scale (``csrc/xnor_matmul.cu``). W is taken as given: surplus
  words that are 0 on both sides cancel. With a :class:`ConvBorder` the rows
  of ``a`` are a convolution's im2col patches, and the kernel's flush adds
  the zero-padding border correction before the scale, so the conv path
  needs no further op.

``bn_sign_pack`` and ``bn_sign`` give the bits of ``bn_sign_plain``, the
reference's chain (bias add, eval batch norm, Eq.-1 sign) with every input
and intermediate result flushed to zero where subnormal, as the reference's
XLA CPU flushes them.

A CPU tensor runs the plain version in ``xnor.ref``; a CUDA tensor launches
the kernel or raises. ``sign_pack.launches`` and ``xnor_matmul.launches``
count kernel launches; ``sign_pack.launches`` counts K3 with and without
its prologue, and ``sign_pack.launches_fused`` those with it among them;
``bn_sign.launches`` counts ``bn_sign_kernel``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.binarize import deterministic_binarize, flush_subnormal
from repro_torch.core.packing import PACK
from repro_torch.kernels import _build
from repro_torch.models.layers import BN_EPS
from repro_torch.xnor import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class ConvBorder(NamedTuple):
    """Where a convolution's zero-padded taps fall, for K4's fused border
    correction. Row m of the patch matrix is output pixel
    ((m // ow) % oh, m % ow); each of its taps (dy, dx) that reads outside
    the (h, w) input adds ``tap_sums[dy * kw + dx]``."""

    tap_sums: torch.Tensor           # (kh*kw, N) int32: sum_c sign(w)[tap, c, n]
    h: int                           # input height and width
    w: int
    oh: int                          # output height and width
    ow: int
    ksize: tuple[int, int]
    stride: tuple[int, int]
    pad0: tuple[int, int]            # leading padding (ph0, pw0)


@functools.lru_cache(maxsize=256)
def _geometry(geo: tuple[int, ...]) -> ctypes.Array:
    """K4's conv geometry (h, w, oh, ow, kh, kw, sh, sw, ph0, pw0) as the
    int32 array its C entry reads, made once per geometry."""
    return (ctypes.c_int * 10)(*geo)


def border_correction_plain(border: ConvBorder, m: int) -> torch.Tensor:
    """(M, N) int32: the correction K4's flush adds, tap by tap, as the
    kernel computes it."""
    kh, kw = border.ksize
    (sh, sw), (ph0, pw0) = border.stride, border.pad0
    rows = torch.arange(m, device=border.tap_sums.device)
    oh, ow = (rows // border.ow) % border.oh, rows % border.ow
    corr = torch.zeros((m, border.tap_sums.shape[1]), dtype=torch.int32,
                       device=border.tap_sums.device)
    for dy in range(kh):
        ih = oh * sh + dy - ph0
        for dx in range(kw):
            iw = ow * sw + dx - pw0
            padded = (ih < 0) | (ih >= border.h) | (iw < 0) | (iw >= border.w)
            corr += padded.to(torch.int32)[:, None] * border.tap_sums[dy * kw + dx][None]
    return corr


def sign_pack_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`sign_pack`, on any device."""
    return ref.sign_pack_ref(x)


def sign_pack(x: torch.Tensor) -> torch.Tensor:
    """(M, K) f32/bf16 -> (M, ceil(K/32)) int32, packed along the last axis."""
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be an (M, K) matrix with K >= 1, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if _build.kernel_device("sign_pack", [x]) == "cpu":
        return sign_pack_plain(x)
    m, k = x.shape
    out = torch.empty((m, (k + PACK - 1) // PACK), dtype=torch.int32, device=x.device)
    if m == 0:
        return out
    code = _build.library().bnn_sign_pack(
        x.data_ptr(), None, None, None, None, None, 0.0, out.data_ptr(), m, k,
        _DTYPES[x.dtype], _build.stream(x.device))
    _build.check(code, "sign_pack")
    sign_pack.launches += 1
    return out


sign_pack.launches = 0
sign_pack.launches_fused = 0   # the launches with the producer prologue among them


def bn_sign_plain(h: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
                  bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, *,
                  eps: float = BN_EPS) -> torch.Tensor:
    """+-1 f32 of h's shape: the Eq.-1 sign of ``(((h + bias) - mean) *
    rsqrt(var + eps)) * bn_scale + bn_bias``, one f32 step at a time in the
    reference's order, with the six inputs and every step's result flushed
    (``flush_subnormal``), as the reference's XLA CPU computes the chain."""
    f = flush_subnormal
    inv_std = torch.rsqrt(f(f(var) + eps))
    y = f(f(f(h) + f(bias)) - f(mean))
    y = f(f(y * inv_std) * f(bn_scale))
    return deterministic_binarize(f(y + f(bn_bias)))


def bn_sign_pack_plain(h: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
                       bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, *,
                       eps: float = BN_EPS) -> torch.Tensor:
    """The plain torch version of :func:`bn_sign_pack`, on any device:
    :func:`bn_sign_plain`, then :func:`sign_pack_plain`."""
    return sign_pack_plain(bn_sign_plain(h, bias, bn_scale, bn_bias, mean, var, eps=eps))


def _bn_checked(name: str, h: torch.Tensor, vecs) -> str:
    """The device rule of the prologue wrappers, after their checks: (M, K)
    f32 activations and five (K,) f32 vectors; bf16 raises ``TypeError``
    (the unfused chain rounds the bias add and the batch norm's output to
    bf16, and the prologue does not)."""
    if h.ndim != 2 or h.shape[1] == 0:
        raise ValueError(f"h must be an (M, K) matrix with K >= 1, got {tuple(h.shape)}")
    if h.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 activations, got {h.dtype}")
    k = h.shape[1]
    for v in vecs:
        if v.shape != (k,) or v.dtype != torch.float32:
            raise ValueError(f"bias, bn_scale, bn_bias, mean and var must be float32 of "
                             f"shape ({k},), got {v.dtype} {tuple(v.shape)}")
    return _build.kernel_device(name, [h, *vecs])


def bn_sign_pack(h: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
                 bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, *,
                 eps: float = BN_EPS) -> torch.Tensor:
    """(M, K) f32 -> (M, ceil(K/32)) int32: the Eq.-1 signs of
    ``batch_norm(h + bias, bn_scale, bn_bias, mean, var)``, flushed as
    :func:`bn_sign_plain`, packed along the last axis; the five vectors are
    (K,) f32. bf16 raises ``TypeError``."""
    vecs = (bias, bn_scale, bn_bias, mean, var)
    if _bn_checked("bn_sign_pack", h, vecs) == "cpu":
        return bn_sign_pack_plain(h, *vecs, eps=eps)
    m, k = h.shape
    out = torch.empty((m, (k + PACK - 1) // PACK), dtype=torch.int32, device=h.device)
    if m == 0:
        return out
    code = _build.library().bnn_sign_pack(
        h.data_ptr(), *(v.data_ptr() for v in vecs), eps, out.data_ptr(), m, k,
        _DTYPES[h.dtype], _build.stream(h.device))
    _build.check(code, "bn_sign_pack")
    sign_pack.launches += 1
    sign_pack.launches_fused += 1
    return out


def bn_sign(h: torch.Tensor, bias: torch.Tensor, bn_scale: torch.Tensor,
            bn_bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, *,
            eps: float = BN_EPS) -> torch.Tensor:
    """(M, K) f32 -> (M, K) f32 +-1: the signs :func:`bn_sign_pack` packs,
    unpacked; the five vectors are (K,) f32. bf16 raises ``TypeError``."""
    vecs = (bias, bn_scale, bn_bias, mean, var)
    if _bn_checked("bn_sign", h, vecs) == "cpu":
        return bn_sign_plain(h, *vecs, eps=eps)
    m, k = h.shape
    out = torch.empty((m, k), dtype=torch.float32, device=h.device)
    if m == 0:
        return out
    code = _build.library().bnn_bn_sign(
        h.data_ptr(), *(v.data_ptr() for v in vecs), eps, out.data_ptr(), m, k,
        _build.stream(h.device))
    _build.check(code, "bn_sign")
    bn_sign.launches += 1
    return out


bn_sign.launches = 0


def xnor_matmul_plain(a_packed: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor | None = None, *, k_total: int,
                      border: ConvBorder | None = None) -> torch.Tensor:
    """The plain torch version of :func:`xnor_matmul`, on any device."""
    if border is None:
        return ref.xnor_matmul_ref(a_packed, w_packed, k_total, scale)
    dot = (ref.xnor_matmul_ref(a_packed, w_packed, k_total)
           + border_correction_plain(border, a_packed.shape[0]))
    return dot if scale is None else dot.to(torch.float32) * scale


def xnor_matmul(a_packed: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor | None = None, *, k_total: int,
                border: ConvBorder | None = None) -> torch.Tensor:
    """(M, W) int32 x (W, N) int32 [+ border correction] [* (N,) f32]
    -> (M, N) int32 (f32 if scaled)."""
    if a_packed.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"a_packed must be (M, W) and w_packed (W, N), got "
                         f"{tuple(a_packed.shape)} and {tuple(w_packed.shape)}")
    m, words = a_packed.shape
    if w_packed.shape[0] != words or words == 0 or w_packed.shape[1] == 0:
        raise ValueError(f"packed K mismatch: a has {words} words, w has "
                         f"{w_packed.shape[0]} (needs equal counts >= 1 and N >= 1)")
    n = w_packed.shape[1]
    if a_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError(f"packed operands must be int32, got {a_packed.dtype} "
                        f"and {w_packed.dtype}")
    if not 0 <= k_total <= words * PACK:
        raise ValueError(f"k_total={k_total} outside [0, {words * PACK}]")
    if scale is not None and (scale.shape != (n,) or scale.dtype != torch.float32):
        raise ValueError(f"scale must be float32 of shape ({n},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if border is not None:
        kh, kw = border.ksize
        if border.tap_sums.shape != (kh * kw, n) or border.tap_sums.dtype != torch.int32:
            raise ValueError(f"tap_sums must be int32 of shape ({kh * kw}, {n}), got "
                             f"{border.tap_sums.dtype} {tuple(border.tap_sums.shape)}")
        if m % (border.oh * border.ow) != 0:
            raise ValueError(f"M={m} is not a whole number of {border.oh}x{border.ow} "
                             f"output images")
    tensors = ([a_packed, w_packed] + ([] if scale is None else [scale])
               + ([] if border is None else [border.tap_sums]))
    if _build.kernel_device("xnor_matmul", tensors) == "cpu":
        return xnor_matmul_plain(a_packed, w_packed, scale, k_total=k_total, border=border)
    out = torch.empty((m, n), dtype=torch.int32 if scale is None else torch.float32,
                      device=a_packed.device)
    if m == 0:
        return out
    code = _build.library().bnn_xnor_matmul(
        a_packed.data_ptr(), w_packed.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if border is None else border.tap_sums.data_ptr(), out.data_ptr(), m, words,
        n, k_total, None if border is None else _geometry(
            (border.h, border.w, border.oh, border.ow, *border.ksize, *border.stride,
             *border.pad0)),
        _build.stream(a_packed.device))
    _build.check(code, "xnor_matmul")
    xnor_matmul.launches += 1
    return out


xnor_matmul.launches = 0
