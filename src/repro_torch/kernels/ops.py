"""Public wrappers around the kernels: leading-dim flattening, the
compute-dtype rule and the random words for stochastic packing (the
threefry twin's, ``core.prng``, over the reference's padded shape; on a
card K1 computes them itself).

Unlike the reference's ops, nothing here pads to blocks or cuts tiny shapes
over to the plain version: the CUDA kernels mask ragged edges themselves,
and the wrappers pick the plain version only for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.packing import PACK, pack_bits, pad_to_pack
from repro_torch.kernels.binary_matmul import binary_matmul as _binary_matmul
from repro_torch.kernels.binary_matmul import binary_matmul_batched as _binary_matmul_batched
from repro_torch.kernels.stoch_binarize import binarize_pack

_BLOCK = 256    # the reference's block_k = block_n, which sets its draw's shape


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


def binary_matmul_batched(x: torch.Tensor, w_packed: torch.Tensor,
                          scale: torch.Tensor | None = None,
                          rows: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`binary_matmul` for each expert of an MoE layer in one launch:
    x (E, C, K) @ unpack(w_packed (E, ceil(K/32), N)) [* scale (E, N)] ->
    (E, C, N) f32, with :func:`binary_matmul`'s compute-dtype rule (the
    reference's ``jax.vmap`` of ``ops.binary_matmul`` over the experts).
    ``rows`` (E,) int64: each expert's live rows, a prefix of its C (the
    rows past it come out +0 [* scale]); None: all C."""
    if x.dtype != torch.float32:
        x = x.to(torch.bfloat16)
    return _binary_matmul_batched(x.contiguous(), w_packed, scale, rows)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def binarize_and_pack(w: torch.Tensor, key: prng.Key | None = None, *,
                      stochastic: bool = False) -> torch.Tensor:
    """Fused binarize (Eq. 1 or 2) + bitpack of a (K, N) master weight to
    (ceil(K/32), N) int32.

    The stochastic rule takes the words of ``key`` (``core.prng``) drawn
    over the shape the reference draws them over, so they equal the
    reference's at the same key: the 32-padded (Kp, N) where the reference
    cuts a tiny shape over to its plain version (256-block padding would
    more than quadruple it), else the 256x256 block-padded (kp, np_). A
    word's row-major index in that draw depends only on its (row, column)
    and the draw's column count, which is all K1 is handed: on a card its
    threefry mode computes each (K, N) word in its loop (none reach
    memory), on the CPU the twin draws them (``stoch_binarize``:
    ``threefry_words``). The ragged pad rows pack as -1 (bit 0)."""
    if not stochastic:
        return binarize_pack(w.contiguous(), stochastic=False)
    if key is None:
        raise ValueError("stochastic binarization requires a key")
    return binarize_pack(w.contiguous(), key=key, draw_cols=draw_cols(*w.shape),
                         stochastic=True)


def draw_cols(k: int, n: int) -> int:
    """Columns of the shape the reference draws a (k, n) leaf's stochastic
    words over (:func:`binarize_and_pack`): n on its tiny cut, else n padded
    to its 256 block."""
    kp, np_ = _ceil_to(_ceil_to(k, PACK), _BLOCK), _ceil_to(n, _BLOCK)
    return n if kp * np_ > 4 * max(k, 1) * max(n, 1) else np_


def pack_master_weights(w: torch.Tensor) -> torch.Tensor:
    """Deterministic pack of an already +-1 (K, ...) tensor to (ceil(K/32),
    ...) int32 (``x > 0`` bit 1, K padded with -1), in plain torch as the
    reference packs it outside any kernel."""
    return pack_bits(pad_to_pack(w, axis=0))
