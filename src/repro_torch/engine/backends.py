"""Built-in layer backends of this slice: ``dense`` and ``packed``.

``packed`` (priority 20) binarizes a (K, N) projection (Eq. 1, or Eq. 2
with words from the pack generator) and bitpacks it with the K1 kernel,
then serves it with the K2 kernel; ``dense`` (0) keeps the master weight
and runs ``torch.matmul``, as the reference leaves dense layers to XLA.
The other datapaths register with their slices.
"""
from __future__ import annotations

import torch

from repro_torch.core.binarize import BinarizeMode
from repro_torch.core.packing import PACK
from repro_torch.engine.registry import (BackendSpec, LeafContext, PackContext,
                                         register_backend)
from repro_torch.kernels import ops
from repro_torch.models.layers import PackedLinear


def _dense_eligible(lc: LeafContext) -> tuple[bool, str]:
    return True, "ok"


def _packable(lc: LeafContext) -> tuple[bool, str]:
    """Gate for the bitpacked-weight matmul backend."""
    if not lc.selected:
        return False, "policy-excluded"
    if lc.is_conv:
        return False, "conv kernel (no packed-weight MXU conv lowering)"
    if lc.ndim < 2:
        return False, f"ndim={lc.ndim} < 2 (not matmul-shaped)"
    if lc.shape[-2] % PACK != 0:
        return False, f"K={lc.shape[-2]} % {PACK} != 0"
    return True, "ok"


def _pack_dense(lc: LeafContext, leaf, pc: PackContext):
    return leaf


def _pack_linear(lc: LeafContext, leaf: torch.Tensor, pc: PackContext) -> PackedLinear:
    """Binarize + bitpack a (K, N) projection; the scale is the mean |w|
    over K (per output channel)."""
    if leaf.ndim != 2:
        raise NotImplementedError(
            f"{lc.path!r}: stacked {tuple(leaf.shape)} leaves pack with the LM slice")
    stochastic = pc.weight_mode is BinarizeMode.STOCHASTIC
    if stochastic and pc.generator is None:
        raise ValueError(
            f"stochastic packing requires a generator, but none was supplied for "
            f"leaf {lc.path!r} (leaf index {lc.index}): pass "
            f"generator=torch.Generator(device).manual_seed(seed) to plan.pack(...), "
            f"or compile the plan with mode='det'")
    packed = ops.binarize_and_pack(leaf, generator=pc.generator, stochastic=stochastic)
    return PackedLinear(packed, leaf.to(torch.float32).abs().mean(dim=0), leaf.shape[0])


def _apply_dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _apply_packed(w: PackedLinear, x: torch.Tensor) -> torch.Tensor:
    return ops.binary_matmul(x, w.packed, w.scale).to(x.dtype)


DENSE = register_backend(BackendSpec(
    name="dense", priority=0, leaf_type=None,
    eligible=_dense_eligible, pack=_pack_dense, apply=_apply_dense,
    doc="Full-width master weights, torch.matmul."))

PACKED = register_backend(BackendSpec(
    name="packed", priority=20, leaf_type=PackedLinear,
    eligible=_packable, pack=_pack_linear, apply=_apply_packed,
    doc="Bitpacked binary weights (+ per-channel scale) through the K2 "
        "packed-weight matmul kernel."))
