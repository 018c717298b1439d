"""K5 wrapper: fused im2col + sign-binarize + bitpack of a conv input.

``patch_pack(x, ksize=..., stride=..., padding=...)`` maps an NHWC
(B, H, W, C) f32/bf16 activation to (B, OH, OW, kh*kw*ceil(C/32)) int32 in
the per-tap word layout (``xnor.conv.packing``). It takes the unpadded
input: the geometry (``conv_geometry``, XLA SAME/VALID/explicit semantics)
tells the kernel where taps fall outside the image, and those vote 0.

A CPU tensor runs the plain version in ``xnor.conv.ref``; a CUDA tensor
launches ``csrc/patch_pack.cu`` or raises. ``patch_pack.launches`` counts
kernel launches.

The kernel stages the input words a tile of the output reads in shared
memory, then copies them out per tap; ``patch_pack_tiles`` chooses that
tile (output rows x columns x channel words x kernel window) from the
geometry alone, here, so that the CPU tests can check it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.xnor.conv import ref
from repro_torch.xnor.conv.packing import conv_geometry, patch_words, tap_words

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Staged words a tile aims at: one pass of kUnroll = 4 loads by each of the
# block's 8 warps (4 f32 words a warp a load), so the staging costs one
# round trip to memory.
STAGE_WORDS = 128
# Shared memory a block may stage in without opting in; a tile never needs
# more.
SMEM_BYTES = 48 * 1024


class PatchTiles(NamedTuple):
    """One block's tile of a K5 launch: output rows x output columns x
    channel words x a taps_y x taps_x window of the kernel. Tiles at the
    ragged ends of each axis are shorter."""
    rows: int
    cols: int
    words: int
    taps_y: int
    taps_x: int

    def staged_words(self, stride) -> int:
        """Input words a full tile stages: rows_in x cols_in x words."""
        return (((self.rows - 1) * stride[0] + self.taps_y)
                * ((self.cols - 1) * stride[1] + self.taps_x) * self.words)

    def smem_bytes(self, stride) -> int:
        """Shared memory of a full tile: its staged words."""
        return 4 * self.staged_words(stride)


@functools.lru_cache(maxsize=256)
def patch_pack_tiles(oh: int, ow: int, c: int, ksize, stride) -> PatchTiles:
    """The tile K5 launches with for an (oh, ow) output of C channels.

    Starting from the whole image, halve the output rows, then the
    columns, then the channel words until a tile stages at most
    ``STAGE_WORDS``, so that every block stages its words in one pass of
    loads and the image spreads over many blocks; then, only if a
    tile still exceeds ``SMEM_BYTES`` (kernels of thousands of taps), halve
    the kernel window's rows and columns. A 1 x 1 x 1-word x 1-tap tile
    needs 4 bytes, so every geometry gets a tile."""
    sizes = [oh, ow, tap_words(c), ksize[0], ksize[1]]

    def shrink(axes, fits):
        for i in axes:
            while sizes[i] > 1 and not fits(PatchTiles(*sizes)):
                sizes[i] = (sizes[i] + 1) // 2

    shrink((0, 1, 2), lambda t: t.staged_words(stride) <= STAGE_WORDS)
    shrink((0, 1, 2, 3, 4), lambda t: t.smem_bytes(stride) <= SMEM_BYTES)
    return PatchTiles(*sizes)


def patch_pack_plain(x: torch.Tensor, *, ksize, stride=(1, 1),
                     padding="SAME") -> torch.Tensor:
    """The plain torch version of :func:`patch_pack`, on any device."""
    return ref.sign_pack_patches_ref(x, ksize, stride, padding)


def patch_pack(x: torch.Tensor, *, ksize, stride=(1, 1), padding="SAME") -> torch.Tensor:
    """(B, H, W, C) -> (B, OH, OW, kh*kw*ceil(C/32)) int32 packed patches."""
    if x.ndim != 4 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, H, W, C) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    oh, ow, ((ph0, _), (pw0, _)) = conv_geometry(h, w, ksize, stride, padding)
    if _build.kernel_device("patch_pack", [x]) == "cpu":
        return patch_pack_plain(x, ksize=ksize, stride=stride, padding=padding)
    tiles = patch_pack_tiles(oh, ow, c, tuple(ksize), tuple(stride))
    out = torch.empty((b, oh, ow, patch_words(ksize, c)), dtype=torch.int32,
                      device=x.device)
    code = _build.library().bnn_patch_pack(
        x.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow, ksize[0], ksize[1],
        stride[0], stride[1], ph0, pw0, _DTYPES[x.dtype], *tiles,
        _build.stream(x.device))
    _build.check(code, "patch_pack")
    patch_pack.launches += 1
    return out


patch_pack.launches = 0
