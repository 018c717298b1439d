"""The tile plan of K5 (``xnor.conv.kernel.patch_pack_tiles``), checked on
the CPU by walking it as ``csrc/patch_pack.cu`` does.

The CUDA kernel runs only on the card. What it does with a plan is plain
index arithmetic, reproduced here in numpy: every tile (column tile x word
tile x kernel-window tile x row band x image) stages its full window of
input words (zero outside the image and past the last channel word), then
copies each output word of the tile's pixels, taps and words from the
staged window, skipping what lies past a ragged edge. Walking the plan must
cover every output word exactly once, stay within a block's shared memory,
and give the plain version's words bit for bit.
"""
import itertools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro_torch.xnor.conv.cases import (PAST_2_31_INPUTS, PAST_2_31_OUTPUT,
                                         PAST_2_31_OUTPUT_CHUNK, TILE_EDGES,
                                         corner_planted, planted_acts)
from repro_torch.xnor.conv.kernel import (SMEM_BYTES, STAGE_WORDS, PatchTiles,
                                          patch_pack_plain, patch_pack_tiles)
from repro_torch.xnor.conv.packing import conv_geometry, tap_words

VGG_INPUTS = [(4, 16, 16, 64), (4, 16, 16, 128), (4, 8, 8, 128), (4, 8, 8, 256),
              (4, 4, 4, 256), (4, 4, 4, 512), (4, 2, 2, 512)]

# (x shape, ksize, stride, padding): VGG's conv inputs, three earlier ragged
# cases, then the edges of the tiling (``cases.TILE_EDGES``).
CASES = [(s, (3, 3), (1, 1), "SAME") for s in VGG_INPUTS] + [
    ((2, 9, 7, 40), (3, 3), (2, 2), "SAME"),
    ((1, 7, 7, 8), (3, 3), (2, 2), "VALID"),
    ((2, 10, 6, 24), (5, 3), (2, 1), ((2, 0), (1, 1))),
] + TILE_EDGES


def _pixel_words(x: np.ndarray) -> np.ndarray:
    """(B, H, W, C) -> (B, H, W, cw) uint32 sign words of each pixel."""
    b, h, w, c = x.shape
    bits = np.zeros((b, h, w, tap_words(c) * 32), np.uint64)
    bits[..., :c] = x > 0
    bits = bits.reshape(b, h, w, -1, 32) << np.arange(32, dtype=np.uint64)
    return bits.sum(axis=-1).astype(np.uint32)


def _walk(x: np.ndarray, ksize, stride, padding, tiles: PatchTiles):
    """The kernel's walk of ``tiles``: (output words, times each was written)."""
    b, h, w, c = x.shape
    (kh, kw), (sh, sw) = ksize, stride
    oh, ow, ((ph0, _), (pw0, _)) = conv_geometry(h, w, ksize, stride, padding)
    cw = tap_words(c)
    words = _pixel_words(x)
    out = np.zeros((b, oh, ow, kh * kw * cw), np.uint32)
    hits = np.zeros(out.shape, np.int32)
    rows_in = (tiles.rows - 1) * sh + tiles.taps_y
    cols_in = (tiles.cols - 1) * sw + tiles.taps_x
    assert rows_in * cols_in * tiles.words == tiles.staged_words(stride)

    def starts(n, step):
        return range(0, n, step)

    for ox0, j0, dy0, dx0, oy0, bi in itertools.product(
            starts(ow, tiles.cols), starts(cw, tiles.words), starts(kh, tiles.taps_y),
            starts(kw, tiles.taps_x), starts(oh, tiles.rows), range(b)):
        # 1. stage the full window; zero outside the image and past cw
        stage = np.zeros((rows_in, cols_in, tiles.words), np.uint32)
        iy0, ix0 = oy0 * sh - ph0 + dy0, ox0 * sw - pw0 + dx0
        ys = slice(max(iy0, 0), min(iy0 + rows_in, h))
        xs = slice(max(ix0, 0), min(ix0 + cols_in, w))
        js = slice(j0, min(j0 + tiles.words, cw))
        if ys.start < ys.stop and xs.start < xs.stop:
            stage[ys.start - iy0:ys.stop - iy0, xs.start - ix0:xs.stop - ix0,
                  :js.stop - j0] = words[bi, ys, xs, js]
        # 2. copy what lies inside the output, the kernel and the words
        nrow, ncol = min(tiles.rows, oh - oy0), min(tiles.cols, ow - ox0)
        nj = js.stop - j0
        for dyl in range(min(tiles.taps_y, kh - dy0)):
            for dxl in range(min(tiles.taps_x, kw - dx0)):
                src = stage[dyl:dyl + (nrow - 1) * sh + 1:sh, dxl:dxl + (ncol - 1) * sw + 1:sw, :nj]
                assert src.shape == (nrow, ncol, nj)      # inside the staged window
                t0 = ((dy0 + dyl) * kw + dx0 + dxl) * cw + j0
                dst = (bi, slice(oy0, oy0 + nrow), slice(ox0, ox0 + ncol), slice(t0, t0 + nj))
                out[dst] = src
                hits[dst] += 1
    return out.view(np.int32), hits


def _n_tiles(b, oh, ow, c, ksize, t: PatchTiles) -> int:
    """Blocks a launch of tile ``t`` needs: one per tile of every image."""
    sizes = (oh, ow, tap_words(c), *ksize)
    return b * int(np.prod([-(-n // k) for n, k in zip(sizes, t)]))


def _tiles(kind, oh, ow, c, ksize, stride) -> PatchTiles:
    """The plan's tile, or another one for the walk to cover: the least
    tile, a small one ragged on most axes, or one that also halves the
    kernel window (a tile's size changes only how the work is cut)."""
    if kind == "plan":
        return patch_pack_tiles(oh, ow, c, ksize, stride)
    if kind == "least":
        return PatchTiles(1, 1, 1, 1, 1)
    if kind == "ragged":
        return PatchTiles(min(2, oh), min(3, ow), min(3, tap_words(c)), *ksize)
    return PatchTiles(1, min(2, ow), 1, -(-ksize[0] // 2), -(-ksize[1] // 2))


@pytest.mark.parametrize("kind", ["plan", "least", "ragged", "half_taps"])
@pytest.mark.parametrize("shape,ksize,stride,pad", CASES)
def test_tile_walk_covers_each_word_once_and_matches_plain(shape, ksize, stride, pad, kind):
    b, h, w, c = shape
    oh, ow, _ = conv_geometry(h, w, ksize, stride, pad)
    tiles = _tiles(kind, oh, ow, c, ksize, stride)
    if kind == "plan":
        assert tiles.smem_bytes(stride) <= SMEM_BYTES
    x = planted_acts(shape, sum(shape)).numpy()
    got, hits = _walk(x, ksize, stride, pad, tiles)
    assert (hits == 1).all()
    want = patch_pack_plain(torch.from_numpy(x), ksize=ksize, stride=stride, padding=pad)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("shape,ksize,stride,pad", CASES)
def test_tile_plan_cuts_rows_then_columns_then_words(shape, ksize, stride, pad):
    """A tile halves its rows, then its columns, then its words until it
    stages at most STAGE_WORDS, and no further; the kernel window is split
    only when it alone exceeds a block's shared memory."""
    b, h, w, c = shape
    oh, ow, _ = conv_geometry(h, w, ksize, stride, pad)
    t = patch_pack_tiles(oh, ow, c, ksize, stride)
    cw = tap_words(c)
    assert 1 <= t.rows <= oh and 1 <= t.cols <= ow and 1 <= t.words <= cw
    if t.rows > 1:
        assert (t.cols, t.words) == (ow, cw)
    if t.cols < ow:
        assert t.rows == 1
    if t.words < cw:
        assert (t.rows, t.cols) == (1, 1)
    if t.staged_words(stride) > STAGE_WORDS:         # out of reach: the least tile
        assert (t.rows, t.cols, t.words) == (1, 1, 1)
    last = next((i for i in (2, 1, 0) if t[i] < (oh, ow, cw)[i]), None)
    if last is not None:          # one halving coarser, the tile misses the target
        coarser = t._replace(**{t._fields[last]: min(2 * t[last], (oh, ow, cw)[last])})
        assert coarser.staged_words(stride) > STAGE_WORDS
    if ksize[0] * ksize[1] * 4 <= SMEM_BYTES:
        assert (t.taps_y, t.taps_x) == ksize
    else:
        assert (t.taps_y, t.taps_x) != ksize and t.smem_bytes(stride) <= SMEM_BYTES


@pytest.mark.parametrize("shape,tiles,blocks", [
    ((4, 16, 16, 64), (1, 16, 2, 3, 3), 64), ((4, 16, 16, 128), (1, 8, 4, 3, 3), 128),
    ((4, 8, 8, 128), (1, 8, 4, 3, 3), 32), ((4, 8, 8, 256), (1, 2, 8, 3, 3), 128),
    ((4, 4, 4, 256), (1, 2, 8, 3, 3), 32), ((4, 4, 4, 512), (1, 1, 8, 3, 3), 128),
    ((4, 2, 2, 512), (1, 1, 8, 3, 3), 32),
])
def test_vgg_tiles(shape, tiles, blocks):
    """The tiles VGG-16's conv inputs launch with at batch 4, and the blocks
    (one a tile) each launch takes."""
    b, h, w, c = shape
    t = patch_pack_tiles(h, w, c, (3, 3), (1, 1))
    assert tuple(t) == tiles and t.staged_words((1, 1)) <= STAGE_WORDS
    assert _n_tiles(b, h, w, c, (3, 3), t) == blocks


def test_tap_window_wider_than_shared_memory_is_split():
    t = patch_pack_tiles(1, 3, 1, (111, 111), (1, 1))
    assert (t.rows, t.cols, t.words) == (1, 1, 1)
    assert t.taps_y * t.taps_x < 111 * 111 and t.smem_bytes((1, 1)) <= SMEM_BYTES


@pytest.mark.parametrize("shape,dtype,stride", PAST_2_31_INPUTS)
def test_past_2_31_input_cases_read_past_2_31(shape, dtype, stride):
    """Each big-input case of the card's checks holds 2^31 elements or more
    and its 1 x 1 VALID output pixel (1, 1) reads a pixel past offset 2^31;
    ``corner_planted`` sets bit 0 of the four pixels' words to 1, 0, 0, 1
    (checked here at a small width with the same strides' pattern)."""
    b, h, w, c = shape
    assert b * h * w * c >= 2**31 and (stride[0] * w + stride[1]) * c >= 2**31
    assert conv_geometry(h, w, (1, 1), stride, "VALID")[:2] == (2, 2)
    small_stride = (2, 3)
    x = torch.randn(1, 3, 4, c).to(dtype)
    corner_planted(x, small_stride)
    got = patch_pack_plain(x, ksize=(1, 1), stride=small_stride, padding="VALID")
    assert (got[..., 0] & 1).flatten().tolist() == [1, 0, 0, 1]


def test_past_2_31_output_case_passes_only_in_the_output():
    (b, h, w, c), ksize, stride, pad = PAST_2_31_OUTPUT
    oh, ow, _ = conv_geometry(h, w, ksize, stride, pad)
    assert b * h * w * c < 2**31 <= b * oh * ow * ksize[0] * ksize[1] * tap_words(c)
    assert b % PAST_2_31_OUTPUT_CHUNK == 0
