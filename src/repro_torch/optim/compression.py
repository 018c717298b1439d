"""1-bit gradient compression with error feedback (signSGD-EF).

Each worker would send ``sign(g + e)`` (1 bit an element) plus one f32
scale (the mean |g + e|), and keep the quantization residual ``e`` as error
feedback, re-injected at the next step (Karimireddy et al. 2019). The
transform is pure; the port has one card, so nothing crosses a wire yet.

The reference's XLA CPU flushes a subnormal ``g + e`` to a zero of its
sign, and ``corrected >= 0`` then signs a negative subnormal +1: the port
flushes ``corrected`` first (``core.binarize.flush_subnormal``) and signs
the same.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.binarize import flush_subnormal
from repro_torch.engine.plan import tree_leaves_with_path, tree_map, tree_unflatten


def compress(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """g, err -> (sign bits as +-1 int8, scale f32 scalar, new_err)."""
    corrected = flush_subnormal(g.to(torch.float32) + err.to(torch.float32))
    scale = torch.mean(torch.abs(corrected))
    sign = torch.where(corrected >= 0, 1, -1).to(torch.int8)
    new_err = corrected - decompress(sign, scale)
    return sign, scale, new_err


def decompress(sign: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return scale * sign.to(torch.float32)


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_tree(grads, err_tree):
    """Applies EF 1-bit compression leaf-wise. Returns
    ``(compressed_grads_f32, new_err_tree)``; the compressed grads come back
    decompressed to f32, so they drop into any optimizer."""
    out = [compress(g, e) for (_, g), (_, e) in zip(tree_leaves_with_path(grads),
                                                     tree_leaves_with_path(err_tree))]
    return (tree_unflatten(grads, (decompress(s, c) for s, c, _ in out)),
            tree_unflatten(grads, (e for _, _, e in out)))


def compressed_bytes(params) -> int:
    """Bytes a step's compressed gradients take (1 bit an element + a scale)."""
    return sum((leaf.numel() + 7) // 8 + 4 for _, leaf in tree_leaves_with_path(params))
