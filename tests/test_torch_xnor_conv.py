"""Port parity for the XNOR conv engine: geometry, per-tap weight packing,
K5's plain version against the reference's Pallas patch kernel (interpret
mode) and jit'd ops, the border correction and ``xnor_conv2d``, and the
dense conv the binarized-dense and packed-conv backends run.

Binary convolutions are exact integers, so every integer comparison is
equality; the dense f32 conv holds rtol 1e-4 / atol 1e-3 (sum order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.models.layers import XnorConv as JXnorConv
from repro.models.layers import apply_conv2d as j_apply_conv2d
from repro.xnor.conv import ops as jcops
from repro.xnor.conv import packing as jcp
from repro.xnor.conv import ref as jcref
from repro.xnor.conv.kernel import patch_pack_pallas
from repro_torch.models.layers import XnorConv, apply_conv2d
from repro_torch.xnor.conv import ops, ref
from repro_torch.xnor.conv import packing as P
from repro_torch.xnor.conv.kernel import patch_pack
from repro_torch.xnor.kernel import ConvBorder, border_correction_plain, xnor_matmul

F32_TOL = dict(rtol=1e-4, atol=1e-3)

# (b, h, w, c, n, kh, kw, sh, sw, padding), the reference's sweep: aligned K,
# stride 2, ragged spatial + K % 32 != 0, first-conv-like C=3, VALID stride 2,
# 1x1 pointwise, asymmetric kernel and stride; plus VGG's 2x2 tail and C=40.
CONV_CASES = [
    (2, 8, 8, 32, 64, 3, 3, 1, 1, "SAME"),
    (2, 8, 8, 32, 48, 3, 3, 2, 2, "SAME"),
    (1, 9, 7, 16, 32, 3, 3, 1, 1, "SAME"),
    (2, 8, 8, 3, 16, 3, 3, 1, 1, "SAME"),
    (1, 7, 7, 8, 8, 3, 3, 2, 2, "VALID"),
    (2, 6, 6, 32, 32, 1, 1, 1, 1, "VALID"),
    (1, 10, 6, 24, 40, 5, 3, 2, 1, "SAME"),
    (4, 2, 2, 64, 24, 3, 3, 1, 1, "SAME"),
    (1, 5, 6, 40, 8, 3, 3, 1, 1, ((2, 0), (1, 1))),
]


def _operands(b, h, w, c, n, kh, kw, seed=0):
    rng = np.random.default_rng(seed + b * h * w + c * n)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    x.reshape(-1)[:3] = [0.0, -0.0, np.nan]
    wk = rng.normal(size=(kh, kw, c, n)).astype(np.float32)
    return x, wk


@pytest.mark.parametrize("b,h,w,c,n,kh,kw,sh,sw,pad", CONV_CASES)
def test_geometry_and_padding_mask_match_reference(b, h, w, c, n, kh, kw, sh, sw, pad):
    args = (h, w, (kh, kw), (sh, sw), pad)
    assert P.conv_geometry(*args) == jcp.conv_geometry(*args)
    np.testing.assert_array_equal(P.padding_mask(*args), jcp.padding_mask(*args))
    assert P.patch_words((kh, kw), c) == jcp.patch_words((kh, kw), c)
    assert P.conv_k((kh, kw), c) == jcp.conv_k((kh, kw), c)
    oh, ow, _ = P.conv_geometry(*args)
    assert (P.patch_nbytes_dense(b, oh, ow, (kh, kw), c),
            P.patch_nbytes_packed(b, oh, ow, (kh, kw), c)) == (
        jcp.patch_nbytes_dense(b, oh, ow, (kh, kw), c),
        jcp.patch_nbytes_packed(b, oh, ow, (kh, kw), c))


@pytest.mark.parametrize("b,h,w,c,n,kh,kw,sh,sw,pad", CONV_CASES)
def test_k5_matches_reference_patch_packing(b, h, w, c, n, kh, kw, sh, sw, pad):
    x, _ = _operands(b, h, w, c, n, kh, kw)
    k = dict(ksize=(kh, kw), stride=(sh, sw), padding=pad)
    got = patch_pack(torch.from_numpy(x), **k)
    want = np.asarray(jcops.sign_and_pack_patches(jnp.asarray(x), **k))  # Pallas, interpret
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.sign_and_pack_patches(torch.from_numpy(x), **k).numpy(),
                                  want)
    np.testing.assert_array_equal(
        ref.conv_patches_ref(torch.from_numpy(x), (kh, kw), (sh, sw), pad).numpy(),
        np.asarray(jcref.conv_patches_ref(jnp.asarray(x), (kh, kw), (sh, sw), pad)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_matches_pallas_kernel_direct(dtype):
    x, _ = _operands(2, 8, 8, 40, 8, 3, 3, seed=1)
    jx = jnp.asarray(x, dtype=dtype)
    xp = jnp.pad(jx, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.asarray(patch_pack_pallas(xp, ksize=(3, 3), oh=8, ow=8, interpret=True))
    got = patch_pack(torch.from_numpy(x).to(getattr(torch, dtype)), ksize=(3, 3))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [3, 32, 40, 64])
def test_kernel_packing_and_tap_sums_match_reference(c):
    _, wk = _operands(1, 4, 4, c, 24, 3, 3, seed=c)
    jw = jcp.pack_conv_kernel(jnp.asarray(wk))
    w = P.pack_conv_kernel(torch.from_numpy(wk))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(P.kernel_tap_sums(w, (3, 3), c).numpy(),
                                  np.asarray(jcp.kernel_tap_sums(jw, (3, 3), c)))
    for args in [(5, 7, (3, 3), (1, 1), "SAME"), (6, 6, (3, 3), (2, 2), "SAME")]:
        np.testing.assert_array_equal(P.border_correction(w, *args, c).numpy(),
                                      np.asarray(jcp.border_correction(jw, *args, c)))
    assert P.border_correction(w, 5, 5, (3, 3), (1, 1), "VALID", c) is None


@pytest.mark.parametrize("b,h,w,c,n,kh,kw,sh,sw,pad", CONV_CASES)
def test_xnor_conv2d_three_way_exact(b, h, w, c, n, kh, kw, sh, sw, pad):
    x, wk = _operands(b, h, w, c, n, kh, kw)
    x = np.nan_to_num(x)       # the dense spec conv would spread a NaN
    wp = P.pack_conv_kernel(torch.from_numpy(wk))
    k = dict(ksize=(kh, kw), c_in=c, stride=(sh, sw), padding=pad)
    got = ops.xnor_conv2d(torch.from_numpy(x), wp, **k)
    assert got.dtype == torch.int32
    want = np.asarray(jcops.xnor_conv2d(jnp.asarray(x), jnp.asarray(wp.numpy()), **k))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.xnor_conv2d_ref(torch.from_numpy(x), wp, **k).numpy(),
                                  want)
    dense = ref.sign_conv_ref(torch.from_numpy(x), torch.from_numpy(wk), (sh, sw), pad)
    np.testing.assert_array_equal(got.numpy(), dense.numpy().astype(np.int32))


def _fused_inputs(b, h, w, c, n, kh, kw, sh, sw, pad, scaled):
    """The packed patches, weights and scale of one conv case, and the
    ConvBorder the CUDA route hands K4 (the leaf's tap sums and geometry)."""
    x, wk = _operands(b, h, w, c, n, kh, kw)
    wp = P.pack_conv_kernel(torch.from_numpy(wk))
    oh, ow, ((ph0, _), (pw0, _)) = P.conv_geometry(h, w, (kh, kw), (sh, sw), pad)
    a = ops.sign_and_pack_patches(torch.from_numpy(x), ksize=(kh, kw), stride=(sh, sw),
                                  padding=pad).reshape(b * oh * ow, -1)
    s = np.abs(wk).mean(axis=(0, 1, 2)).astype(np.float32) if scaled else None
    border = ConvBorder(XnorConv(wp, None, (kh, kw), c).tap_sums, h, w, oh, ow, (kh, kw),
                        (sh, sw), (ph0, pw0))
    return x, wp, a, s, border, (oh, ow)


@pytest.mark.parametrize("b,h,w,c,n,kh,kw,sh,sw,pad", CONV_CASES)
@pytest.mark.parametrize("scaled", [False, True])
def test_fused_k4_plain_matches_reference_conv(b, h, w, c, n, kh, kw, sh, sw, pad, scaled):
    """K4 with the border correction and the scale in its flush (the plain
    version its CUDA kernel is held against) equals the reference's
    xnor_conv2d: raw dot + correction table + epilogue, bit for bit."""
    x, wp, a, s, border, (oh, ow) = _fused_inputs(b, h, w, c, n, kh, kw, sh, sw, pad,
                                                 scaled)
    got = xnor_matmul(a, wp, None if s is None else torch.from_numpy(s),
                      k_total=kh * kw * c, border=border)
    assert got.dtype == (torch.float32 if scaled else torch.int32)
    want = np.asarray(jcops.xnor_conv2d(
        jnp.asarray(x), jnp.asarray(wp.numpy()), None if s is None else jnp.asarray(s),
        ksize=(kh, kw), c_in=c, stride=(sh, sw), padding=pad))
    np.testing.assert_array_equal(got.reshape(b, oh, ow, n).numpy(), want)


@pytest.mark.parametrize("b,h,w,c,n,kh,kw,sh,sw,pad", CONV_CASES)
def test_fused_border_rows_equal_the_correction_table(b, h, w, c, n, kh, kw, sh, sw, pad):
    """The flush's tap-by-tap correction, row by row, equals the
    reference's (OH*OW, N) table repeated over the batch."""
    x, wp, a, _, border, (oh, ow) = _fused_inputs(b, h, w, c, n, kh, kw, sh, sw, pad, False)
    table = jcp.border_correction(jnp.asarray(wp.numpy()), h, w, (kh, kw), (sh, sw), pad, c)
    want = (np.zeros((oh * ow, n), np.int32) if table is None else np.asarray(table))
    np.testing.assert_array_equal(border_correction_plain(border, b * oh * ow).numpy(),
                                  np.tile(want, (b, 1)))


@pytest.mark.parametrize("c", [3, 40, 64])
def test_xnor_conv_leaf_holds_its_tap_sums(c):
    """The leaf computes the reference's kernel_tap_sums once, when made, and
    keeps them through .to(); a given table is kept as it is."""
    _, wk = _operands(1, 4, 4, c, 24, 3, 3, seed=c)
    wp = P.pack_conv_kernel(torch.from_numpy(wk))
    leaf = XnorConv(wp, None, (3, 3), c)
    want = np.asarray(jcp.kernel_tap_sums(jnp.asarray(wp.numpy()), (3, 3), c))
    assert leaf.tap_sums.dtype == torch.int32 and leaf.tap_sums.shape == (9, 24)
    np.testing.assert_array_equal(leaf.tap_sums.numpy(), want)
    moved = leaf.to("cpu")
    assert type(moved) is XnorConv and torch.equal(moved.tap_sums, leaf.tap_sums)
    given = torch.zeros(9, 24, dtype=torch.int32)
    assert XnorConv(wp, None, (3, 3), c, given).tap_sums is given


def test_border_correction_is_load_bearing():
    x, wk = _operands(1, 6, 6, 32, 16, 3, 3, seed=4)
    wp = P.pack_conv_kernel(torch.from_numpy(wk))
    got = ops.xnor_conv2d(torch.from_numpy(x), wp, ksize=(3, 3), c_in=32)
    from repro_torch.xnor.ops import xnor_matmul_packed
    a = ops.sign_and_pack_patches(torch.from_numpy(x), ksize=(3, 3))
    raw = xnor_matmul_packed(a.reshape(36, -1), wp, k=288).reshape(1, 6, 6, 16)
    assert torch.equal(got[:, 1:-1, 1:-1], raw[:, 1:-1, 1:-1])     # interior
    assert not torch.equal(got, raw)                                # borders differ


def test_xnor_conv_layer_scaled_matches_reference_bit_for_bit():
    x, wk = _operands(2, 8, 8, 64, 32, 3, 3, seed=5)
    wp = P.pack_conv_kernel(torch.from_numpy(wk))
    s = np.abs(wk).mean(axis=(0, 1, 2)).astype(np.float32)
    want = np.asarray(j_apply_conv2d(JXnorConv(jnp.asarray(wp.numpy()), jnp.asarray(s),
                                               (3, 3), 64), jnp.asarray(x)))
    got = apply_conv2d(XnorConv(wp, torch.from_numpy(s), (3, 3), 64), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride,pad", [((1, 1), "SAME"), ((2, 2), "SAME"),
                                        ((1, 2), "VALID"), ((1, 1), ((2, 0), (0, 1)))])
def test_dense_conv_matches_reference(stride, pad):
    x, wk = _operands(2, 7, 8, 5, 12, 3, 3, seed=6)
    x = np.nan_to_num(x)
    want = np.asarray(j_apply_conv2d(jnp.asarray(wk), jnp.asarray(x), stride=stride,
                                     padding=pad if isinstance(pad, str) else list(pad)))
    got = apply_conv2d(torch.from_numpy(wk), torch.from_numpy(x), stride=stride,
                       padding=pad)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_xnor_conv2d_checks_its_inputs():
    wp = torch.zeros(9, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="expects C"):
        ops.xnor_conv2d(torch.zeros(1, 4, 4, 16), wp, ksize=(3, 3), c_in=32)
    with pytest.raises(ValueError, match="layout needs"):
        ops.xnor_conv2d(torch.zeros(1, 4, 4, 40), wp, ksize=(3, 3), c_in=40)
    with pytest.raises(ValueError, match="empty conv output"):
        patch_pack(torch.zeros(1, 2, 2, 8), ksize=(3, 3), padding="VALID")
    with pytest.raises(TypeError):
        patch_pack(torch.zeros(1, 4, 4, 8, dtype=torch.float64), ksize=(3, 3))
