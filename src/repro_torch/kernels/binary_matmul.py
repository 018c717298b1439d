"""K2 wrapper: matmul against bitpacked binary weights.

``binary_matmul(x, w_packed, scale)`` computes
``x (M, K) @ unpack(w_packed)[:K] [* scale]`` in f32, with ``x``'s dtype
(f32 or bf16) as the compute dtype: products with +-1 are exact, so only
the order of the f32 sum differs between kernel and plain version. K need
not be a multiple of 32: ``w_packed`` has ceil(K/32) word rows and the bits
past K are ignored.

``binary_matmul_batched(x, w_packed, scale, rows)`` is the expert-batched
mode: x (E, M, K) against E packed weights (E, ceil(K/32), N) [* (E, N)
scales] -> (E, M, N) f32 in one launch, each expert's output equal bit for
bit to a 2-D call on its slices (the reference's ``jax.vmap`` of its kernel
over an MoE layer's experts). ``rows`` (E,) int64 gives each expert's
live rows, the prefix ``[0, min(rows[e], M))``: the rows past it
are +0 [* scale], what the product gives on the zero rows an MoE dispatch
buffer holds there, and the kernel reads no word of an expert with none.
``None``: every row is live.

A CPU tensor runs the plain version in ``kernels.ref``; a CUDA tensor
launches ``csrc/binary_matmul.cu`` or raises. ``binary_matmul.launches``
and ``binary_matmul_batched.launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PACK
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y = 65535         # the batched launch's experts, one per grid.y


def _check_operands(x: torch.Tensor, w_packed: torch.Tensor, scale, lead: tuple) -> None:
    """The dtype and K rules both modes share; ``lead`` is () or (E,)."""
    k, (k32, n) = x.shape[-1], w_packed.shape[-2:]
    if k == 0 or n == 0 or k32 != (k + PACK - 1) // PACK:
        raise ValueError(f"x has K={k}, w_packed has {k32} word rows "
                         f"(needs ceil(K/32) and N >= 1)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_packed.dtype != torch.int32:
        raise TypeError(f"w_packed must be int32, got {w_packed.dtype}")
    if scale is not None and (scale.shape != (*lead, n) or scale.dtype != torch.float32):
        raise ValueError(f"scale must be float32 of shape {(*lead, n)}, got "
                         f"{scale.dtype} {tuple(scale.shape)}")


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
    n = w_packed.shape[1]
    _check_operands(x, w_packed, scale, ())
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


def binary_matmul_batched_plain(x: torch.Tensor, w_packed: torch.Tensor,
                                scale: torch.Tensor | None = None,
                                rows: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version of :func:`binary_matmul_batched`, on any device."""
    return ref.binary_matmul_batched_ref(x, w_packed, scale, rows, compute_dtype=x.dtype)


def binary_matmul_batched(x: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor | None = None,
                          rows: torch.Tensor | None = None) -> torch.Tensor:
    """(E, M, K) f32/bf16 @ unpack((E, ceil(K/32), N) int32) [* (E, N) f32]
    -> (E, M, N) f32, one launch for all E experts; expert e's rows from
    ``rows[e]`` on are +0 [* scale]."""
    if x.ndim != 3 or w_packed.ndim != 3 or x.shape[0] != w_packed.shape[0]:
        raise ValueError(f"x must be (E, M, K) and w_packed (E, K/32, N), got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    e, m, k = x.shape
    n = w_packed.shape[2]
    _check_operands(x, w_packed, scale, (e,))
    if rows is not None:
        if rows.shape != (e,):
            raise ValueError(f"rows must have shape {(e,)}, got {tuple(rows.shape)}")
        if rows.dtype != torch.int64:
            raise TypeError(f"rows must be int64, got {rows.dtype}")
    if e > _GRID_Y:
        raise ValueError(f"E={e} experts: the launch puts one expert on each grid.y "
                         f"(at most {_GRID_Y})")
    tensors = [x, w_packed] + [t for t in (scale, rows) if t is not None]
    if _build.kernel_device("binary_matmul_batched", tensors) == "cpu":
        return binary_matmul_batched_plain(x, w_packed, scale, rows)
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if m == 0 or e == 0:
        return out
    lib = _build.library()
    code = lib.bnn_binary_matmul_batched(
        x.data_ptr(), w_packed.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(),
        e, m, k, n, _DTYPES[x.dtype], _build.stream(x.device))
    _build.check(code, "binary_matmul_batched")
    binary_matmul_batched.launches += 1
    return out


binary_matmul_batched.launches = 0
