"""K5 wrapper: fused im2col + sign-binarize + bitpack of a conv input.

``patch_pack(x, ksize=..., stride=..., padding=...)`` maps an NHWC
(B, H, W, C) f32/bf16 activation to (B, OH, OW, kh*kw*ceil(C/32)) int32 in
the per-tap word layout (``xnor.conv.packing``). It takes the unpadded
input: the geometry (``conv_geometry``, XLA SAME/VALID/explicit semantics)
tells the kernel where taps fall outside the image, and those vote 0.

A CPU tensor runs the plain version in ``xnor.conv.ref``; a CUDA tensor
launches ``csrc/patch_pack.cu`` or raises. ``patch_pack.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.xnor.conv import ref
from repro_torch.xnor.conv.packing import conv_geometry, patch_words

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def patch_pack_plain(x: torch.Tensor, *, ksize, stride=(1, 1),
                     padding="SAME") -> torch.Tensor:
    """The plain torch version of :func:`patch_pack`, on any device."""
    return ref.sign_pack_patches_ref(x, ksize, stride, padding)


def patch_pack(x: torch.Tensor, *, ksize, stride=(1, 1), padding="SAME") -> torch.Tensor:
    """(B, H, W, C) -> (B, OH, OW, kh*kw*ceil(C/32)) int32 packed patches."""
    if x.ndim != 4 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, H, W, C) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    oh, ow, ((ph0, _), (pw0, _)) = conv_geometry(h, w, ksize, stride, padding)
    if _build.kernel_device("patch_pack", [x]) == "cpu":
        return patch_pack_plain(x, ksize=ksize, stride=stride, padding=padding)
    out = torch.empty((b, oh, ow, patch_words(ksize, c)), dtype=torch.int32,
                      device=x.device)
    code = _build.library().bnn_patch_pack(
        x.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow, ksize[0], ksize[1],
        stride[0], stride[1], ph0, pw0, _DTYPES[x.dtype],
        _build.stream(x.device))
    _build.check(code, "patch_pack")
    patch_pack.launches += 1
    return out


patch_pack.launches = 0
