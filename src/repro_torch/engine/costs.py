"""Per-backend layer cost model: device-memory bytes moved and op counts.

The arithmetic ``plan_report`` quotes for every plan row, a copy of the
reference's ``engine/costs.py``. Every cost is for one (M, K) x (K, N) GEMM
application of a layer; a convolution is costed at its im2col GEMM, where
K = kh*kw*C and M = batch * OH * OW output positions.

Conventions (the reference's): activations stream at ``act_bytes`` per
element (bf16 = 2), outputs are written at 4 bytes (f32 accumulator),
packed tensors move 1 bit per element in int32 words, and the optional
per-channel scale adds N * 4 bytes to the weight fetch.
"""
from __future__ import annotations

from repro_torch.core import packing as wpack
from repro_torch.core import roofline as R
from repro_torch.xnor.conv.packing import patch_words


def dense_weight_bytes(shape: tuple[int, ...], act_bytes: int = 2) -> int:
    """bf16 storage of the full master or binarized-dense leaf."""
    n = 1
    for d in shape:
        n *= d
    return n * act_bytes


def packed_weight_bytes(shape: tuple[int, ...], *, conv: bool = False,
                        with_scale: bool = True, flat: bool = False) -> int:
    """int32 bitpacked storage (+ f32 scale) of a projection or conv leaf.

    Conv leaves count the xnor per-tap word layout (kh*kw*ceil(C/32));
    ``flat=True`` counts packed_conv's flat layout (ceil(kh*kw*C/32)) instead;
    the two differ when C % 32 != 0."""
    if conv:
        kh, kw, c, n = shape[-4:]
        if flat:
            k = kh * kw * c
            words = ((k + wpack.PACK - 1) // wpack.PACK) * n
        else:
            words = patch_words((kh, kw), c) * n
        lead = shape[:-4]
    else:
        k, n = shape[-2:]
        words = ((k + wpack.PACK - 1) // wpack.PACK) * n
        lead = shape[:-2]
    stack = 1
    for d in lead:
        stack *= d
    return stack * (words * 4 + (n * 4 if with_scale else 0))


def gemm_cost(backend: str, m: int, k: int, n: int, *,
              act_bytes: int = 2, with_scale: bool = True,
              shape: tuple[int, ...] | None = None) -> dict:
    """{"bytes": device bytes, "ops": MAC-equivalent ops} for one application.

    ``backend`` is a registry name: ``binarized_dense`` moves dense-width
    weights, ``packed`` 1-bit weights and full-width activations,
    ``xnor``/``xnor_conv`` 1-bit operands on both sides, with the dot done
    as popcounts over 32x fewer words. Pass the conv leaf ``shape``
    (kh, kw, C, N) for ``xnor_conv`` so words count in the per-tap layout
    (kh*kw*ceil(C/32), as ``packed_weight_bytes``)."""
    out = m * n * 4
    act = m * k * act_bytes
    scale = n * 4 if with_scale else 0
    if backend in ("dense", "binarized_dense"):
        return {"bytes": k * n * act_bytes + act + out, "ops": 2 * m * k * n}
    if backend == "packed":
        return {"bytes": wpack.packed_nbytes((k, n)) + scale + act + out,
                "ops": 2 * m * k * n}
    if backend in ("xnor", "xnor_conv"):
        words = (k + wpack.PACK - 1) // wpack.PACK
        if backend == "xnor_conv" and shape is not None and len(shape) >= 4:
            kh, kw, c = shape[-4], shape[-3], shape[-2]
            words = patch_words((kh, kw), c)
        return {"bytes": words * n * 4 + scale + m * words * 4 + out,
                "ops": 2 * m * words * n}
    raise KeyError(f"no cost model for backend {backend!r}")


def roofline_seconds(backend: str, m: int, k: int, n: int, **kw) -> float:
    """max(bytes / HBM_BW, ops / peak bf16 rate): the least time the card
    (``core.roofline``) could take for one application."""
    c = gemm_cost(backend, m, k, n, **kw)
    return max(c["bytes"] / R.HBM_BW, c["ops"] / R.PEAK_FLOPS_BF16)
