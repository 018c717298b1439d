"""Public wrappers around the kernels: leading-dim flattening, the
compute-dtype rule and the random words for stochastic packing.

Unlike the reference's ops, nothing here pads to blocks or cuts tiny shapes
over to the plain version: the CUDA kernels mask ragged edges themselves,
and the wrappers pick the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binary_matmul import binary_matmul as _binary_matmul
from repro_torch.kernels.stoch_binarize import binarize_pack


def binary_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                  scale: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ unpack(w_packed) [* scale]`` for x of shape (..., K), in f32.

    The compute dtype is f32 for f32 activations (parity with the dense
    path) and bf16 for anything else."""
    *lead, k = x.shape
    if x.dtype != torch.float32:
        x = x.to(torch.bfloat16)
    out = _binary_matmul(x.reshape(-1, k).contiguous(), w_packed, scale)
    return out.reshape(*lead, w_packed.shape[-1])


def random_words(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform uint32 words as int32 bit patterns, drawn from ``generator``."""
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=device)


def binarize_and_pack(w: torch.Tensor, bits: torch.Tensor | None = None,
                      generator: torch.Generator | None = None, *,
                      stochastic: bool = False) -> torch.Tensor:
    """Fused binarize (Eq. 1 or 2) + bitpack of a (K, N) master weight to
    (ceil(K/32), N) int32. The stochastic rule uses ``bits`` when given,
    else words drawn from ``generator`` on w's device."""
    if stochastic and bits is None:
        if generator is None:
            raise ValueError("stochastic binarization requires bits or a generator")
        bits = random_words(w.shape, generator, w.device)
    return binarize_pack(w.contiguous(), bits, stochastic=stochastic)
