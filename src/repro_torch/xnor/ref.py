"""Plain torch versions of the XNOR-popcount kernels (exact integer ground
truth), mirroring the reference's ``xnor/ref.py``. Straight-line tensor
code: the K3/K4 wrappers run these for tensors on the CPU, and the tests
and ``chip_smoke.py`` hold the kernels against them on the card. All views
of the binary dot product are exactly equal (integers, no rounding):

  * ``xnor_matmul_ref`` -- popcount over packed operands (what K4 does),
  * ``sign_matmul_ref`` -- ``sign(x) @ sign(w)`` in f32 (the semantic spec).
"""
from __future__ import annotations

import torch

from repro_torch.core.binarize import deterministic_binarize
from repro_torch.core.packing import to_uint32
from repro_torch.xnor import packing as apack


def sign_pack_ref(x: torch.Tensor) -> torch.Tensor:
    """Fused sign-binarize (Eq. 1) + bitpack along the last axis."""
    return apack.pack_activations(apack.pad_features(x))


def xnor_matmul_ref(a_packed: torch.Tensor, w_packed: torch.Tensor, k: int,
                    scale: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """``dot[m, n] = k - 2 * sum_j popcount(a[m, j] ^ w[j, n])``.

    ``a_packed``: (..., K32) int32, ``w_packed``: (K32, N) int32, ``k``: the
    true contraction length. ``out_dtype`` defaults to int32, or f32 when a
    scale is applied."""
    if a_packed.shape[-1] != w_packed.shape[0]:
        raise ValueError(f"packed K mismatch: a has {a_packed.shape[-1]} words, "
                         f"w has {w_packed.shape[0]}")
    if out_dtype is None:
        out_dtype = torch.int32 if scale is None else torch.float32
    x = to_uint32(a_packed).unsqueeze(-1) ^ to_uint32(w_packed)   # (..., K32, N)
    dot = k - 2 * apack.popcount(x).sum(dim=-2, dtype=torch.int32)
    if scale is not None:
        dot = dot.to(torch.float32) * scale.to(torch.float32)
    return dot.to(out_dtype)


def sign_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The semantic spec: ``sign(x) @ sign(w)`` computed densely in f32."""
    xs = deterministic_binarize(x).to(torch.float32)
    ws = deterministic_binarize(w).to(torch.float32)
    return xs @ ws


def xnor_forward_ref(x: torch.Tensor, w_packed: torch.Tensor, k: int,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """End-to-end oracle: sign-pack the activations, then popcount matmul.
    ``w_packed`` covers ``ceil(k / 32)`` words (``core.packing`` layout)."""
    return xnor_matmul_ref(sign_pack_ref(x), w_packed, k, scale)
