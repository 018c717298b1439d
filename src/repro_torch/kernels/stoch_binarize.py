"""K1 wrapper: fused (deterministic | stochastic) binarize + bitpack.

``binarize_pack(w, bits, stochastic=...)`` maps a (K, N) f32/bf16 master
weight to (ceil(K/32), N) int32 words (``core.packing`` layout). The
stochastic rule thresholds caller-supplied uniform uint32 words (passed as
int32 bit patterns) against hard_sigmoid(w), exactly as the reference's
operand variant does, so both sides can be fed the same words.

A CPU tensor runs the plain version in ``kernels.ref``; a CUDA tensor
launches ``csrc/binarize_pack.cu`` or raises. ``binarize_pack.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PACK, pad_to_pack
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def binarize_pack_plain(w: torch.Tensor, bits: torch.Tensor | None, *,
                        stochastic: bool) -> torch.Tensor:
    """The plain torch version of :func:`binarize_pack`, on any device."""
    wp = pad_to_pack(w, axis=0)   # -1 rows pack to bit 0 under both rules
    if not stochastic:
        return ref.det_binarize_pack_ref(wp)
    bp = torch.zeros(wp.shape, dtype=torch.int32, device=w.device)
    bp[: w.shape[0]] = bits
    return ref.stoch_binarize_pack_ref(wp, bp)


def binarize_pack(w: torch.Tensor, bits: torch.Tensor | None = None, *,
                  stochastic: bool) -> torch.Tensor:
    """(K, N) master weight [+ (K, N) int32 words] -> (ceil(K/32), N) int32."""
    if w.ndim != 2 or w.shape[0] == 0 or w.shape[1] == 0:
        raise ValueError(f"w must be a non-empty (K, N) matrix, got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if stochastic:
        if bits is None:
            raise ValueError("stochastic=True requires bits")
        if bits.shape != w.shape or bits.dtype != torch.int32:
            raise ValueError(f"bits must be int32 of shape {tuple(w.shape)}, got "
                             f"{bits.dtype} {tuple(bits.shape)}")
    if _build.kernel_device("binarize_pack", [w] + ([bits] if stochastic else [])) == "cpu":
        return binarize_pack_plain(w, bits, stochastic=stochastic)
    k, n = w.shape
    out = torch.empty(((k + PACK - 1) // PACK, n), dtype=torch.int32, device=w.device)
    lib = _build.library()
    code = lib.bnn_binarize_pack(
        w.data_ptr(), bits.data_ptr() if stochastic else None, out.data_ptr(),
        k, n, _DTYPES[w.dtype], int(stochastic),
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(code, "binarize_pack")
    binarize_pack.launches += 1
    return out


binarize_pack.launches = 0
