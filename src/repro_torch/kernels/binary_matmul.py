"""K2 wrapper: matmul against bitpacked binary weights.

``binary_matmul(x, w_packed, scale)`` computes
``x (M, K) @ unpack(w_packed)[:K] [* scale]`` in f32, with ``x``'s dtype
(f32 or bf16) as the compute dtype: products with +-1 are exact, so only
the order of the f32 sum differs between kernel and plain version. K need
not be a multiple of 32: ``w_packed`` has ceil(K/32) word rows and the bits
past K are ignored.

A CPU tensor runs the plain version in ``kernels.ref``; a CUDA tensor
launches ``csrc/binary_matmul.cu`` or raises. ``binary_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PACK
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def binary_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version of :func:`binary_matmul`, on any device."""
    return ref.binary_matmul_ref(x, w_packed, scale, compute_dtype=x.dtype)


def binary_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                  scale: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) f32/bf16 @ unpack((ceil(K/32), N) int32) [* (N,) f32] -> (M, N) f32."""
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"x must be (M, K) and w_packed (K/32, N), got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    m, k = x.shape
    k32, n = w_packed.shape
    if k == 0 or n == 0 or k32 != (k + PACK - 1) // PACK:
        raise ValueError(f"x has K={k}, w_packed has {k32} word rows "
                         f"(needs ceil(K/32) and N >= 1)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_packed.dtype != torch.int32:
        raise TypeError(f"w_packed must be int32, got {w_packed.dtype}")
    if scale is not None and (scale.shape != (n,) or scale.dtype != torch.float32):
        raise ValueError(f"scale must be float32 of shape ({n},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    tensors = [x, w_packed] + ([] if scale is None else [scale])
    if _build.kernel_device("binary_matmul", tensors) == "cpu":
        return binary_matmul_plain(x, w_packed, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = _build.library()
    code = lib.bnn_binary_matmul(
        x.data_ptr(), w_packed.data_ptr(),
        None if scale is None else scale.data_ptr(), out.data_ptr(),
        m, k, n, _DTYPES[x.dtype], _build.stream(x.device))
    _build.check(code, "binary_matmul")
    binary_matmul.launches += 1
    return out


binary_matmul.launches = 0
