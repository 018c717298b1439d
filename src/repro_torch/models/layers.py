"""Base layers: linear application (dense or bitpacked binary), eval-mode
batch norm and the He initializer.

Models are binarization-agnostic: the serving path substitutes
:class:`PackedLinear` leaves for master weights, and ``apply_linear``
dispatches on the leaf type through the ``repro_torch.engine`` registry, so
the same model code serves every datapath.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PackedLinear:
    """Bitpacked binary weight: ``unpack(packed)[:k] * scale`` of shape (k, N)."""

    packed: torch.Tensor             # (ceil(k / 32), N) int32
    scale: torch.Tensor | None       # (N,) f32 or None
    k: int                           # true contraction size

    def nbytes(self) -> int:
        """Bytes stored: the packed words plus the scale."""
        s = 0 if self.scale is None else self.scale.numel() * 4
        return self.packed.numel() * 4 + s

    def to(self, device) -> "PackedLinear":
        return PackedLinear(self.packed.to(device),
                            None if self.scale is None else self.scale.to(device),
                            self.k)


def apply_linear(w, x: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ bias); the leaf type of ``w`` selects its backend."""
    from repro_torch.engine import registry

    out = registry.apply_linear(w, x)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def he_normal(generator: torch.Generator, shape, *, device,
              dtype=torch.float32, fan_in: int | None = None) -> torch.Tensor:
    """He initialization (the paper's choice for FC nets)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = (2.0 / max(fan_in, 1)) ** 0.5
    return std * torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm over the last axis with running stats, in f32."""
    x32 = x.to(torch.float32)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)
