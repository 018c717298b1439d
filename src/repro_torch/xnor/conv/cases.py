"""Inputs that hold K5 (``kernel.patch_pack``) to its plain version at the
edges of its tiling, shared by the port's tests and ``chip_smoke.py``.

A case is ``(x shape, ksize, stride, padding)``. The big cases need a card:
their tensors hold 2^31 elements or words or more, so the kernel indexes
them in 64 bits.
"""
from __future__ import annotations

import numpy as np
import torch

# The edges of the tiling: a row wider than a column tile (and C % 32 != 0),
# stride 2 with odd H and W, kh != kw with explicit asymmetric padding,
# H = W = 1, a channel row wider than a block's shared memory (4,201 words a
# pixel), and a 111 x 111 kernel window wider than it.
TILE_EDGES = [
    ((1, 5, 300, 33), (3, 3), (1, 1), "SAME"),
    ((2, 9, 11, 40), (3, 3), (2, 2), "SAME"),
    ((1, 7, 9, 16), (1, 3), (1, 1), ((0, 2), (3, 1))),
    ((3, 1, 1, 64), (3, 3), (1, 1), "SAME"),
    ((1, 2, 3, 4200 * 32 + 7), (3, 3), (1, 1), "SAME"),
    ((1, 111, 113, 1), (111, 111), (1, 1), "VALID"),
]

# A batch past grid.z's 65,535 blocks.
BATCH_PAST_GRID = ((70000, 1, 1, 32), (1, 1), (1, 1), "VALID")

# Inputs of more than 2^31 elements, (shape, dtype, stride) with a 1 x 1
# VALID kernel: output pixel (1, 1) reads the pixel at (sh, sw), whose
# offset is past 2^31. With the output case below they launch each of the
# kernel's four 64-bit instantiations: bf16 element loads (C = 1, 4.6 GB),
# bf16 16-byte loads (C = 8, 4.6 GB), f32 16-byte loads (C = 4, 9.2 GB).
PAST_2_31_INPUTS = [
    ((1, 70000, 32768, 1), torch.bfloat16, (66000, 16384)),
    ((1, 70000, 4096, 8), torch.bfloat16, (66000, 2048)),
    ((1, 70000, 8192, 4), torch.float32, (66000, 4096)),
]

# An input of 240,000,000 f32 elements whose 3 x 3 SAME patches are
# 2,160,000,000 words (8.6 GB): only the output passes 2^31, and C = 1
# takes the f32 element loads. The images are independent, so the output
# is held to the plain version in batch chunks of PAST_2_31_OUTPUT_CHUNK.
PAST_2_31_OUTPUT = ((15_000_000, 4, 4, 1), (3, 3), (1, 1), "SAME")
PAST_2_31_OUTPUT_CHUNK = 125_000


def planted_acts(shape, seed, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normal activations from ``seed`` with 0.0, -0.0 and NaN each planted
    at about one element in 20, throughout."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    at = rng.integers(0, flat.size, size=(3, max(1, flat.size // 20)))
    flat[at[0]], flat[at[1]], flat[at[2]] = 0.0, -0.0, np.nan
    return torch.from_numpy(x).to(device, dtype)


def corner_planted(x: torch.Tensor, stride) -> None:
    """Plant 1.0, -0.0, NaN and 2.0 in channel 0 of the four pixels a 1 x 1
    VALID kernel at ``stride`` reads first, (0, 0), (0, sw), (sh, 0) and
    (sh, sw): bit 0 of their words reads 1, 0, 0, 1."""
    sh, sw = stride
    x[0, 0, 0, 0], x[0, 0, sw, 0], x[0, sh, 0, 0], x[0, sh, sw, 0] = (
        1.0, -0.0, float("nan"), 2.0)
