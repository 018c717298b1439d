"""The port's CUDA kernels against their plain versions, and the rules that
keep a CUDA tensor from reaching a plain version.

Tests marked ``cuda`` need an NVIDIA GPU and nvcc; they decide inside the
test whether a card is present and skip here otherwise. This file imports
neither JAX nor the reference package, so it also runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.packing import unpack_bits
from repro_torch.core.policy import DEFAULT_POLICY, make_paper_policy
from repro_torch.engine import ExecutionPlan, compile_plan
from repro_torch.engine.plan import tree_leaves_with_path, tree_map
from repro_torch.kernels import _build, ops
from repro_torch.kernels.binary_matmul import (binary_matmul, binary_matmul_batched,
                                               binary_matmul_batched_plain, binary_matmul_plain)
from repro_torch.kernels.stoch_binarize import binarize_pack, binarize_pack_plain
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.layers import XnorConv, apply_conv2d, conv2d_nhwc
from repro_torch.stoch import ensemble_forward, sample_replicas
from repro_torch.xnor import cases as k3_cases
from repro_torch.xnor import ops as xops
from repro_torch.xnor.conv import cases as k5_cases
from repro_torch.xnor.conv.kernel import patch_pack, patch_pack_plain
from repro_torch.xnor.conv.ops import xnor_conv2d
from repro_torch.xnor.conv.packing import pack_conv_kernel
from repro_torch.xnor.kernel import (ConvBorder, bn_sign, bn_sign_pack, bn_sign_pack_plain,
                                     bn_sign_plain, sign_pack, sign_pack_plain, xnor_matmul,
                                     xnor_matmul_plain)
from repro_torch.xnor.packing import unpack_activations

F32_TOL = dict(rtol=1e-4, atol=1e-3)   # only the order of the f32 sum differs
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(k, n, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.7, (k, n)).astype(np.float32)
    w[0], w[1 % k], w[2 % k] = 1.0, -1.0, -0.0
    bits = rng.integers(0, 2**32, (k, n), dtype=np.uint64).astype(np.uint32)
    bits[0, : min(n, 128)] = (2**32 - 1 - np.arange(min(n, 128))).astype(np.uint32)
    return (torch.from_numpy(w).to(device, dtype),
            torch.from_numpy(bits.view(np.int32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2048), (784, 2048), (100, 300), (33, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stochastic", [False, True])
def test_k1_matches_plain(cuda, k, n, dtype, stochastic):
    w, bits = _weights(k, n, k + n, cuda, dtype)
    b = bits if stochastic else None
    got = binarize_pack(w, b, stochastic=stochastic)
    want = binarize_pack_plain(w, b, stochastic=stochastic)
    assert got.shape == ((k + 31) // 32, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (256, 2048, 2048), (5, 100, 300),
                                   (33, 32, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [False, True])
def test_k2_matches_plain(cuda, m, k, n, dtype, scaled):
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda, dtype)
    w, _ = _weights(k, n, m + k, cuda)
    wp = binarize_pack(w, stochastic=False)
    scale = (torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(cuda)
             if scaled else None)
    got = binary_matmul(x, wp, scale)
    want = binary_matmul_plain(x, wp, scale)
    torch.testing.assert_close(got, want, **(F32_TOL if dtype == torch.float32
                                             else BF16_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2048), (784, 2048), (100, 300), (33, 1), (31, 5),
                                 (65, 33), (65535 * 32 + 100, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_onchip_matches_plain(cuda, k, n, dtype):
    """The in-kernel Philox words and the plain version's agree bit for bit
    (the seed exceeds 2^32 at the large shapes, so both reduce it mod 2^32),
    at the edges of the block of 8 warps x 32 columns of one word row: K < 32,
    K % 32 != 0, N % 32 != 0, and word rows past grid.y's 65,535."""
    w, _ = _weights(k, n, k + n, cuda, dtype)
    seed = (k * n) ** 2 + 1
    got = binarize_pack(w, stochastic=True, seed=seed, on_chip_prng=True)
    want = binarize_pack_plain(w, None, stochastic=True, seed=seed, on_chip_prng=True)
    assert got.shape == ((k + 31) // 32, n)
    assert torch.equal(got, want)


def _k2_inputs(m, k, n, dtype, scaled, device):
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(device, dtype)
    wp = binarize_pack(_weights(k, n, m + k, device)[0], stochastic=False)
    scale = (torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(device)
             if scaled else None)
    return x, wp, scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 33, 256])
@pytest.mark.parametrize("k,n", [(2048, 2048), (512, 512), (784, 2048), (100, 300),
                                 (32, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [False, True])
def test_k2_row_groups_and_k_splits_match_plain(cuda, m, k, n, dtype, scaled):
    """Every M (whole and partial 4-row groups), the serving (K, N) and
    ragged K/N (K slices with no words, partial words, partial columns)."""
    x, wp, scale = _k2_inputs(m, k, n, dtype, scaled, cuda)
    torch.testing.assert_close(binary_matmul(x, wp, scale), binary_matmul_plain(x, wp, scale),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 512, 512), (33, 784, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_is_bit_identical_run_to_run(cuda, m, k, n, dtype):
    """The split-K partial sums are reduced in a fixed order, with no atomics."""
    x, wp, scale = _k2_inputs(m, k, n, dtype, True, cuda)
    first = binary_matmul(x, wp, scale)
    assert all(torch.equal(binary_matmul(x, wp, scale), first) for _ in range(5))


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches(cuda):
    w, _ = _weights(64, 128, 0, cuda)
    k1, k2 = binarize_pack.launches, binary_matmul.launches
    wp = ops.binarize_and_pack(w, prng.key(0), stochastic=True)
    ops.binary_matmul(torch.ones(2, 3, 64, device=cuda), wp)
    assert (binarize_pack.launches - k1, binary_matmul.launches - k2) == (1, 1)


@pytest.mark.cuda
def test_k1_onchip_launches_are_counted_apart(cuda):
    """launches counts every K1 mode; launches_on_chip only the on-chip one."""
    w, bits = _weights(64, 128, 0, cuda)
    total, on_chip = binarize_pack.launches, binarize_pack.launches_on_chip
    binarize_pack(w, bits, stochastic=True)
    binarize_pack(w, stochastic=False)
    assert (binarize_pack.launches - total, binarize_pack.launches_on_chip - on_chip) == (2, 0)
    binarize_pack(w, stochastic=True, seed=3, on_chip_prng=True)
    assert (binarize_pack.launches - total, binarize_pack.launches_on_chip - on_chip) == (3, 1)


@pytest.mark.cuda
def test_serve_smoke_runs_the_kernels(cuda):
    binarize_pack.launches = binary_matmul.launches = 0
    res = serve.serve_classifier(binarize="stoch", slots=4, requests=8, smoke=True)
    assert binarize_pack.launches == 1            # one packed hidden layer
    assert res.warmup == 1 and len(res.batch_seconds) == 2
    assert binary_matmul.launches == 3            # one warm-up and two timed batches
    assert res.last_logits.device.type == "cuda"
    assert torch.isfinite(res.last_logits).all()


def test_cpu_tensors_take_the_plain_version():
    w, bits = _weights(40, 8, 1, "cpu")
    k1, k2 = binarize_pack.launches, binary_matmul.launches
    wp = binarize_pack(w, bits, stochastic=True)
    torch.testing.assert_close(binary_matmul(torch.ones(3, 40), wp),
                               binary_matmul_plain(torch.ones(3, 40), wp))
    assert (binarize_pack.launches, binary_matmul.launches) == (k1, k2)


@pytest.mark.parametrize("call", [
    lambda: binarize_pack(torch.empty(64, 8, device="meta"), stochastic=False),
    lambda: binary_matmul(torch.empty(2, 64, device="meta"),
                          torch.empty(2, 8, dtype=torch.int32, device="meta")),
])
def test_other_devices_raise(call):
    """Only CPU tensors reach a plain version; any other device raises."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        call()


@pytest.mark.parametrize("call,err", [
    (lambda: binarize_pack(torch.zeros(64, 8, dtype=torch.float64), stochastic=False),
     TypeError),
    (lambda: binarize_pack(torch.zeros(64, 8), stochastic=True), ValueError),
    (lambda: binarize_pack(torch.zeros(64, 8), torch.zeros(64, 8, dtype=torch.int64),
                           stochastic=True), ValueError),
    (lambda: binary_matmul(torch.zeros(2, 64), torch.zeros(3, 8, dtype=torch.int32)),
     ValueError),
    (lambda: binary_matmul(torch.zeros(2, 64), torch.zeros(2, 8)), TypeError),
    (lambda: binary_matmul(torch.zeros(2, 64), torch.zeros(2, 8, dtype=torch.int32),
                           torch.zeros(7)), ValueError),
])
def test_wrappers_check_their_inputs(call, err):
    with pytest.raises(err):
        call()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build_library(tmp_path / "build")


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_classifier(smoke=True, requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])


def _acts(shape, seed, device, dtype=torch.float32):
    """Normal activations with 0.0, -0.0 and NaN planted."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[: min(x.size, 3)] = np.array([0.0, -0.0, np.nan], np.float32)[: x.size]
    return torch.from_numpy(x).to(device, dtype)


def _words(shape, seed, device):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    w.reshape(-1)[:4] = np.array([0, -1, -(2**31), 2**31 - 1], np.int32)[: w.size]
    return torch.from_numpy(w).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(4, 2048), (4, 512), (5, 100), (7, 33), (1024, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda, m, k, dtype):
    x = _acts((m, k), m + k, cuda, dtype)
    got = sign_pack(x)
    assert got.shape == (m, (k + 31) // 32)
    assert torch.equal(got, sign_pack_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", k3_cases.FUSED_SHAPES + [k3_cases.PAST_GRID_SHAPE])
def test_k3_with_prologue_matches_its_plain_chain(cuda, m, k):
    """Bias, eval batch norm and sign in K3's load give the unfused chain's
    bits on the card, planted BN outputs (0.0, -0.0, NaN, 0 * inf,
    +-2^-149, exactly 0 and one step either side) included; one launch,
    counted under sign_pack and as fused."""
    case = k3_cases.plant_near_zero(k3_cases.bn_inputs(m, k, m * k, cuda))
    before = (sign_pack.launches, sign_pack.launches_fused)
    got = bn_sign_pack(*case)
    assert (sign_pack.launches, sign_pack.launches_fused) == (before[0] + 1, before[1] + 1)
    assert got.shape == (m, (k + 31) // 32)
    assert torch.equal(got, bn_sign_pack_plain(*case))


@pytest.mark.cuda
def test_k3_prologue_rsqrt_equals_torch_rsqrt(cuda):
    """The prologue's rsqrt equals torch.rsqrt on every positive normal f32
    (a subnormal var + eps is flushed before it)."""
    assert k3_cases.rsqrt_sweep(cuda) == 0x7F800000 - 0x00800000


@pytest.mark.cuda
def test_k3_prologue_refuses_bf16_on_the_card(cuda):
    h, *vecs = k3_cases.bn_inputs(4, 64, 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        bn_sign_pack(h.to(torch.bfloat16), *vecs)


# (M, words, N, k): mnist_fc's hidden layers, VGG conv/2..12 and fc/1 at batch
# 4, ragged M/N, K % 32 != 0, and surplus words (allow_extra_words layouts);
# M < 64 runs one row a thread, M >= 64 four (a large M, and a ragged last
# row group of each tiling)
K4_SHAPES = [(4, 64, 2048, 2048), (1024, 18, 128, 576), (256, 72, 256, 2304),
             (16, 144, 512, 4608), (4, 16, 512, 512), (5, 4, 300, 100),
             (33, 9, 65, 9 * 8), (3, 1, 1, 7), (4096, 72, 256, 2304), (65, 5, 33, 150),
             (63, 33, 40, 1050)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,words,n,k", K4_SHAPES)
@pytest.mark.parametrize("scaled", [False, True])
def test_k4_matches_plain(cuda, m, words, n, k, scaled):
    a, w = _words((m, words), m + n, cuda), _words((words, n), words + k, cuda)
    scale = (torch.from_numpy(np.random.default_rng(n).uniform(0.5, 2, n)
                              .astype(np.float32)).to(cuda) if scaled else None)
    got = xnor_matmul(a, w, scale, k_total=k)
    assert got.dtype == (torch.float32 if scaled else torch.int32)
    assert torch.equal(got, xnor_matmul_plain(a, w, scale, k_total=k))


# K5's cases: VGG's first and last conv inputs and the earlier ragged cases,
# then the edges of the tiled kernel (``cases.TILE_EDGES``), a batch past
# grid.z's 65,535 and a VGG input, with 0.0 / -0.0 / NaN planted throughout.
K5_CASES = [
    ((4, 16, 16, 64), (3, 3), (1, 1), "SAME", False),
    ((4, 2, 2, 512), (3, 3), (1, 1), "SAME", False),
    ((2, 9, 7, 40), (3, 3), (2, 2), "SAME", False),
    ((1, 7, 7, 8), (3, 3), (2, 2), "VALID", False),
    ((2, 10, 6, 24), (5, 3), (2, 1), ((2, 0), (1, 1)), False),
] + [(*case, True) for case in k5_cases.TILE_EDGES + [k5_cases.BATCH_PAST_GRID]] + [
    ((4, 8, 8, 256), (3, 3), (1, 1), "SAME", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ksize,stride,pad,planted", K5_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain(cuda, shape, ksize, stride, pad, planted, dtype):
    if planted:
        x = k5_cases.planted_acts(shape, sum(shape), dtype, cuda)
    else:
        x = _acts(shape, sum(shape), cuda, dtype)
    k = dict(ksize=ksize, stride=stride, padding=pad)
    assert torch.equal(patch_pack(x, **k), patch_pack_plain(x, **k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 11, 40), (4, 8, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain_on_an_unaligned_input(cuda, shape, dtype):
    """An input that starts one element past a 16-byte boundary."""
    x = k5_cases.planted_acts(shape, 7, dtype, cuda)
    xu = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    assert torch.equal(patch_pack(xu, ksize=(3, 3)), patch_pack_plain(x, ksize=(3, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,stride", k5_cases.PAST_2_31_INPUTS)
def test_k5_takes_an_input_past_2_31_elements(cuda, shape, dtype, stride):
    """An input of more than 2^31 elements takes the kernel's 64-bit
    indexing: output pixel (1, 1) reads a pixel past offset 2^31."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, dtype=dtype, device=cuda)
    assert x.numel() > 2**31
    assert (stride[0] * shape[2] + stride[1]) * shape[3] > 2**31
    k5_cases.corner_planted(x, stride)
    k = dict(ksize=(1, 1), stride=stride, padding="VALID")
    got = patch_pack(x, **k)
    assert (got[..., 0] & 1).flatten().tolist() == [1, 0, 0, 1]
    assert torch.equal(got, patch_pack_plain(x, **k))


@pytest.mark.cuda
def test_k5_takes_an_output_past_2_31_words(cuda):
    """An output of more than 2^31 words from an input of fewer than 2^31
    elements also takes the 64-bit indexing; held to the plain version in
    batch chunks (the images are independent)."""
    shape, ksize, stride, pad = k5_cases.PAST_2_31_OUTPUT
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda)
    x[torch.rand(shape, generator=g, device=cuda) < 0.05] = float("nan")
    x[::7, 1, 2] = 0.0
    x[::11, 2, 1] = -0.0
    assert x.numel() < 2**31
    k = dict(ksize=ksize, stride=stride, padding=pad)
    got = patch_pack(x, **k)
    assert got.numel() > 2**31
    step = k5_cases.PAST_2_31_OUTPUT_CHUNK
    for b0 in range(0, shape[0], step):
        assert torch.equal(got[b0:b0 + step], patch_pack_plain(x[b0:b0 + step], **k)), b0


@pytest.mark.cuda
def test_dense_conv_stays_full_f32(cuda):
    """cuDNN would run an f32 conv in TF32 by default; the dense conv apply
    switches that off, so it matches an f64 conv to f32 precision."""
    torch.backends.cudnn.allow_tf32 = True
    x = _acts((4, 32, 32, 64), 1, cuda).nan_to_num()
    w = _acts((3, 3, 64, 64), 2, cuda).nan_to_num()
    pads = ((1, 1), (1, 1))
    got = conv2d_nhwc(x, w, (1, 1), pads)
    want = conv2d_nhwc(x.double(), w.double(), (1, 1), pads)
    assert torch.backends.cudnn.allow_tf32          # the global flag is restored
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode,per_batch,packs", [
    # one hidden xnor layer: its input site fused, its output site on bn_sign
    ("mnist_fc", "xnor", {"sign_pack": 1, "xnor_matmul": 1, "bn_sign": 1}, 1),
    ("vgg16_cifar10", "det", {"binary_matmul": 1}, 1),
    ("vgg16_cifar10", "stoch", {"binary_matmul": 1}, 13),
    ("vgg16_cifar10", "xnor", {"sign_pack": 1, "xnor_matmul": 12, "patch_pack": 11,
                               "bn_sign": 12}, 12),
])
def test_new_serves_run_the_kernels(cuda, arch, mode, per_batch, packs):
    counters = {"binarize_pack": binarize_pack, "binary_matmul": binary_matmul,
                "sign_pack": sign_pack, "xnor_matmul": xnor_matmul,
                "patch_pack": patch_pack, "bn_sign": bn_sign}
    for fn in counters.values():
        fn.launches = 0
    res = serve.serve_classifier(arch=arch, binarize=mode, slots=4, requests=8,
                                 smoke=True)
    batches = res.warmup + len(res.batch_seconds)
    want = {name: per_batch.get(name, 0) * batches for name in counters}
    want["binarize_pack"] = packs
    assert {name: fn.launches for name, fn in counters.items()} == want
    assert res.last_logits.device.type == "cuda" and torch.isfinite(res.last_logits).all()


def test_new_wrappers_take_the_plain_version_on_cpu():
    counts = (sign_pack.launches, xnor_matmul.launches, patch_pack.launches)
    x = _acts((3, 40), 0, "cpu")
    assert torch.equal(sign_pack(x), sign_pack_plain(x))
    a, w = _words((3, 2), 1, "cpu"), _words((2, 5), 2, "cpu")
    assert torch.equal(xnor_matmul(a, w, k_total=40), xnor_matmul_plain(a, w, k_total=40))
    x4 = _acts((1, 4, 4, 8), 3, "cpu")
    assert torch.equal(patch_pack(x4, ksize=(3, 3)), patch_pack_plain(x4, ksize=(3, 3)))
    assert (sign_pack.launches, xnor_matmul.launches, patch_pack.launches) == counts


@pytest.mark.parametrize("call", [
    lambda: sign_pack(torch.empty(2, 64, device="meta")),
    lambda: xnor_matmul(torch.empty(2, 2, dtype=torch.int32, device="meta"),
                        torch.empty(2, 8, dtype=torch.int32, device="meta"), k_total=64),
    lambda: patch_pack(torch.empty(1, 4, 4, 8, device="meta"), ksize=(3, 3)),
])
def test_new_wrappers_raise_on_other_devices(call):
    with pytest.raises(ValueError, match="cpu or cuda"):
        call()


@pytest.mark.parametrize("call,err", [
    (lambda: sign_pack(torch.zeros(2, 64, dtype=torch.float64)), TypeError),
    (lambda: sign_pack(torch.zeros(2, 3, 64)), ValueError),
    (lambda: xnor_matmul(torch.zeros(2, 2, dtype=torch.int32),
                         torch.zeros(3, 8, dtype=torch.int32), k_total=64), ValueError),
    (lambda: xnor_matmul(torch.zeros(2, 2, dtype=torch.int32),
                         torch.zeros(2, 8, dtype=torch.int32), k_total=65), ValueError),
    (lambda: xnor_matmul(torch.zeros(2, 2), torch.zeros(2, 8), k_total=64), TypeError),
    (lambda: xnor_matmul(torch.zeros(2, 2, dtype=torch.int32),
                         torch.zeros(2, 8, dtype=torch.int32), torch.zeros(7),
                         k_total=64), ValueError),
    (lambda: patch_pack(torch.zeros(4, 4, 8), ksize=(3, 3)), ValueError),
])
def test_new_wrappers_check_their_inputs(call, err):
    with pytest.raises(err):
        call()


def test_vgg_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "vgg16_cifar10", "--binarize", "xnor", "--smoke",
                    "--requests", "1"])


# VGG-16's 11 xnor conv layers at batch 4 ((B, H, W, C), N, ksize, stride,
# padding), then the layout sweep: stride 2, C % 32 != 0 (surplus words in
# the per-tap layout), ragged H/W, C=3, VALID, 1x1, a 5x3 kernel with stride
# (2, 1), explicit asymmetric padding and a ragged N
FUSED_CONVS = [(shape, n, (3, 3), (1, 1), "SAME") for shape, n in [
    ((4, 16, 16, 64), 128), ((4, 16, 16, 128), 128), ((4, 8, 8, 128), 256),
    ((4, 8, 8, 256), 256), ((4, 8, 8, 256), 256), ((4, 4, 4, 256), 512),
    ((4, 4, 4, 512), 512), ((4, 4, 4, 512), 512), ((4, 2, 2, 512), 512),
    ((4, 2, 2, 512), 512), ((4, 2, 2, 512), 512)]] + [
    ((2, 8, 8, 32), 48, (3, 3), (2, 2), "SAME"), ((2, 9, 7, 40), 65, (3, 3), (2, 2), "SAME"),
    ((1, 9, 7, 16), 32, (3, 3), (1, 1), "SAME"), ((2, 8, 8, 3), 16, (3, 3), (1, 1), "SAME"),
    ((1, 7, 7, 8), 8, (3, 3), (2, 2), "VALID"), ((2, 6, 6, 32), 32, (1, 1), (1, 1), "VALID"),
    ((1, 10, 6, 24), 40, (5, 3), (2, 1), "SAME"),
    ((1, 5, 6, 40), 8, (3, 3), (1, 1), ((2, 0), (1, 1)))]


def _xnor_conv_leaf(c, n, ksize, scaled, device="cpu"):
    rng = np.random.default_rng(c * n + ksize[0])
    wk = torch.from_numpy(rng.normal(size=(*ksize, c, n)).astype(np.float32))
    leaf = XnorConv(pack_conv_kernel(wk), wk.abs().mean(dim=(0, 1, 2)) if scaled else None,
                    ksize, c)
    return leaf.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,ksize,stride,pad", FUSED_CONVS)
@pytest.mark.parametrize("scaled", [False, True])
def test_fused_k4_conv_matches_plain_route(cuda, shape, n, ksize, stride, pad, scaled):
    """On CUDA the conv is K5 then K4 with the border correction and the
    scale in its flush; it equals the CPU route (raw dot, correction table,
    epilogue) bit for bit, int32 and scaled f32 alike."""
    x = _acts(shape, sum(shape) + n, "cpu")
    leaf = _xnor_conv_leaf(shape[-1], n, ksize, scaled)
    kw = dict(ksize=ksize, c_in=shape[-1], stride=stride, padding=pad)
    want = xnor_conv2d(x, leaf.packed, leaf.scale, **kw)
    gl = leaf.to(cuda)
    counts = (patch_pack.launches, xnor_matmul.launches)
    got = xnor_conv2d(x.to(cuda), gl.packed, gl.scale, tap_sums=gl.tap_sums, **kw)
    assert (patch_pack.launches, xnor_matmul.launches) == (counts[0] + 1, counts[1] + 1)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((4, 16, 16, 64), 128), ((4, 2, 2, 512), 512)])
def test_xnor_conv_layer_on_cuda_matches_cpu(cuda, shape, n):
    """The serving seam (apply_conv2d on an XnorConv leaf, f32 out) on the
    card equals the same leaf on the CPU, and launches one K5 and one K4."""
    x = _acts(shape, n, "cpu")
    leaf = _xnor_conv_leaf(shape[-1], n, (3, 3), True)
    want = apply_conv2d(leaf, x)
    counts = (patch_pack.launches, xnor_matmul.launches)
    got = apply_conv2d(leaf.to(cuda), x.to(cuda))
    assert (patch_pack.launches, xnor_matmul.launches) == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,words,n", [(4, 64, 2048), (64, 18, 128)])
def test_k4_launches_are_counted_once_per_call(cuda, m, words, n):
    a, w = _words((m, words), m, cuda), _words((words, n), n, cuda)
    before = xnor_matmul.launches
    xnor_matmul(a, w, k_total=words * 32)
    ts = torch.zeros(9, n, dtype=torch.int32, device=cuda)
    xnor_matmul(a, w, torch.ones(n, device=cuda), k_total=words * 32,
                border=ConvBorder(ts, 2, m // 4, 2, m // 4, (3, 3), (1, 1), (1, 1)))
    assert xnor_matmul.launches == before + 2


@pytest.mark.cuda
def test_k2_takes_m_past_the_old_grid_limit(cuda):
    """M = 65535 * 4 + 1, one past the old grid.y limit: the row groups are
    walked with a grid stride, and two calls stay bit-identical."""
    m = 65535 * 4 + 1
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(m, 32))
                         .astype(np.float32)).to(cuda)
    wp = binarize_pack(_weights(32, 8, 1, cuda)[0], stochastic=False)
    got = binary_matmul(x, wp)
    torch.testing.assert_close(got, binary_matmul_plain(x, wp), **F32_TOL)
    assert torch.equal(binary_matmul(x, wp), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_k4_takes_n_past_the_old_grid_limit(cuda, m):
    """N = 65535 * 64 + 1, one past the old grid.y limit, with W = 1, at one
    and at four rows a thread (the blocks are numbered along grid.x)."""
    n = 65535 * 64 + 1
    a, w = _words((m, 1), m, cuda), _words((1, n), 7, cuda)
    got = xnor_matmul(a, w, k_total=32)
    assert torch.equal(got, xnor_matmul_plain(a, w, k_total=32))
    assert torch.equal(xnor_matmul(a, w, k_total=32), got)


@pytest.mark.cuda
def test_twin_words_on_cuda_equal_cpu(cuda):
    """The threefry twin's words do not depend on the device: a 2048 x 2048
    draw (the 256-block-padded shape of a 2048 x 2048 leaf) and its uniform
    floats are equal on the card and on the CPU."""
    k = prng.split(prng.fold_in(prng.key(1), 2), 1)[0]
    assert torch.equal(prng.bits(k, (2048, 2048), cuda).cpu(), prng.bits(k, (2048, 2048)))
    assert torch.equal(prng.uniform(k, (300, 500), cuda).cpu(), prng.uniform(k, (300, 500)))
    # past one chunk of the card's route, with a ragged last chunk
    n = prng.WORDS_CHUNK["cuda"] + 12345
    assert torch.equal(prng.bits(k, (n,), cuda).cpu(), prng.bits(k, (n,)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 2048), (784, 2048), (64, 64), (300, 100)])
def test_stoch_pack_on_cuda_equals_cpu(cuda, k, n):
    """Twin words on the card, then K1's operand mode, equal the CPU pack at
    the same key (both of the reference's draw shapes)."""
    w, _ = _weights(k, n, k + n, "cpu")
    key = prng.key(k + n)
    got = ops.binarize_and_pack(w.to(cuda), key, stochastic=True)
    assert torch.equal(got.cpu(), ops.binarize_and_pack(w, key, stochastic=True))


@pytest.mark.parametrize("border,err", [
    (ConvBorder(torch.zeros(8, 8, dtype=torch.int32), 2, 2, 2, 2, (3, 3), (1, 1), (1, 1)),
     "tap_sums must be"),
    (ConvBorder(torch.zeros(9, 8, dtype=torch.int64), 2, 2, 2, 2, (3, 3), (1, 1), (1, 1)),
     "tap_sums must be"),
    (ConvBorder(torch.zeros(9, 8, dtype=torch.int32), 3, 3, 3, 3, (3, 3), (1, 1), (1, 1)),
     "output images"),
])
def test_k4_checks_its_border(border, err):
    a, w = _words((8, 2), 1, "cpu"), _words((2, 8), 2, "cpu")
    with pytest.raises(ValueError, match=err):
        xnor_matmul(a, w, k_total=64, border=border)


# ---------------------------------------------------------------------------
# Eq. 1's threshold, loaded manifests and the ensemble, on the card
# ---------------------------------------------------------------------------

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks" / "golden_plans"


def _planted_bits_hold(bits, want):
    """``bits``: 0/1 with the planted dim last; ``want``: -1 where unplanted."""
    m = want >= 0
    return torch.equal(bits.cpu().long()[..., m], want[m].expand_as(bits.cpu()[..., m]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eq1_threshold_on_the_card(cuda, dtype):
    """Subnormals of both signs, 2^-126 and the next value, -2^-126, +-0
    and NaN (``xnor.cases.sign_plants``) through K1 det, plain K3 and K5:
    the kernels equal their plain versions on the CPU, and sign +1 only at
    2^-126 and above."""
    w = torch.randn(100, 40, generator=torch.Generator().manual_seed(1)).to(dtype)
    want = k3_cases.plant_signs(w, 0)
    got = binarize_pack(w.to(cuda), stochastic=False).cpu()
    assert torch.equal(got, binarize_pack_plain(w, None, stochastic=False))
    assert _planted_bits_hold((unpack_bits(got)[:100] > 0).T, want)
    x = torch.randn(5, 100, generator=torch.Generator().manual_seed(2)).to(dtype)
    want = k3_cases.plant_signs(x, 1)
    got = sign_pack(x.to(cuda)).cpu()
    assert torch.equal(got, sign_pack_plain(x))
    assert _planted_bits_hold(unpack_activations(got)[:, :100] > 0, want)
    x = torch.randn(2, 5, 6, 40, generator=torch.Generator().manual_seed(3)).to(dtype)
    want = k3_cases.plant_signs(x, 3)
    for ks, pad in (((1, 1), "VALID"), ((3, 3), "SAME")):
        got = patch_pack(x.to(cuda), ksize=ks, padding=pad).cpu()
        assert torch.equal(got, patch_pack_plain(x, ksize=ks, padding=pad))
    assert _planted_bits_hold(unpack_activations(
        patch_pack(x.to(cuda), ksize=(1, 1), padding="VALID").cpu())[..., :40] > 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(4, 2048), (4, 512), (7, 100)])
def test_eq1_threshold_at_the_fused_sites_on_the_card(cuda, m, k):
    case, want = k3_cases.plant_bn_signs(k3_cases.bn_inputs(m, k, 40 + k, "cpu"))
    got = bn_sign_pack(*(t.to(cuda) for t in case)).cpu()
    assert torch.equal(got, bn_sign_pack_plain(*case))
    assert _planted_bits_hold(unpack_activations(got)[:, :k] > 0, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_loaded_golden_packs_identically_on_the_card(cuda, arch, mode):
    """The committed manifest, loaded and packed on the card at full width,
    gives the words of a compile packed on the CPU from the same masters."""
    tree, _, _, n_fc = serve.build_model(arch, 0, device=cuda)
    loaded = ExecutionPlan.load(GOLDEN / f"{arch}_{mode}.json")
    on_card = loaded.pack(tree["params"], key=prng.key(1))
    masters = tree_map(lambda t: t.cpu(), tree["params"])
    on_cpu = compile_plan(masters, make_paper_policy(n_fc), mode).pack(masters,
                                                                        key=prng.key(1))
    for (path, a), (_, b) in zip(tree_leaves_with_path(on_card), tree_leaves_with_path(on_cpu)):
        assert type(a) is type(b), path
        if hasattr(a, "packed"):
            assert torch.equal(a.packed.cpu(), b.packed), path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
def test_ensemble_k1_is_the_single_sample_serve_on_the_card(cuda, arch):
    single = serve.serve_classifier(arch=arch, binarize="stoch", slots=4, requests=8,
                                    smoke=True)
    tree, apply_fn, _, _ = serve.build_model(arch, 0, device=cuda, smoke=True)
    rs = sample_replicas(tree["params"], single.plan, prng.key(1), 1)
    with torch.inference_mode():
        es = ensemble_forward(rs, lambda t: apply_fn(t, single.state, single.last_x))
    assert torch.equal(es.mean_logits, single.last_logits)
    k3 = serve.serve_classifier(arch=arch, binarize="stoch", slots=4, requests=8, smoke=True,
                                ensemble=3)
    assert k3.replicas.k == 3 and len(k3.agreement) == 8
    assert torch.isfinite(k3.last_logits).all()


# ---------------------------------------------------------------------------
# bn_sign, the flushed prologue, and Alg.-1 training on the card
# ---------------------------------------------------------------------------

# (M, K) of the sign sites bn_sign serves: mnist_fc's 2->3, VGG's conv 1-11
# outputs and fc/1 at batch 4; ragged K; and M * K past 2^24 threads' grid
BN_SIGN_SHAPES = [(4, 2048), (4096, 64), (1024, 128), (256, 256), (64, 512), (16, 512),
                  (4, 512), (7, 100), (3, 31), (70000, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", BN_SIGN_SHAPES)
def test_bn_sign_matches_its_plain_version(cuda, m, k):
    """+-1 of the flushed chain on the card equals its plain version on the
    card, planted BN outputs included; one launch, counted."""
    case = k3_cases.plant_near_zero(k3_cases.bn_inputs(m, k, m + k, cuda))
    before = bn_sign.launches
    got = bn_sign(*case)
    assert bn_sign.launches == before + 1
    assert got.shape == (m, k) and got.dtype == torch.float32
    assert torch.equal(got, bn_sign_plain(*case))
    assert torch.equal(sign_pack(got), bn_sign_pack(*case))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5])
def test_flushed_steps_on_the_card(cuda, m):
    """A subnormal at each flushed step (``xnor.cases.FLUSH_PLANTS``):
    bn_sign and fused K3 give the plain chain's bits on the CPU and the
    planted bits (the reference's)."""
    for eps, case, bits in k3_cases.flush_cases(m, "cpu"):
        on_card = tuple(t.to(cuda) for t in case)
        got = bn_sign(*on_card, eps=eps).cpu()
        assert torch.equal(got, bn_sign_plain(*case, eps=eps))
        assert torch.equal((got > 0).long(), bits.expand(m, -1))
        assert torch.equal(bn_sign_pack(*on_card, eps=eps).cpu(),
                           bn_sign_pack_plain(*case, eps=eps))


@pytest.mark.cuda
def test_bn_sign_refuses_bf16_on_the_card(cuda):
    h, *vecs = k3_cases.bn_inputs(4, 64, 0, cuda)
    with pytest.raises(TypeError, match="float32"):
        bn_sign(h.to(torch.bfloat16), *vecs)


def _tree_close(got, want, tol):
    want = list(tree_leaves_with_path(want))
    scale = max(float(t.abs().max()) for _, t in want)
    for (path, a), (_, b) in zip(tree_leaves_with_path(got), want):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=tol, atol=tol * scale,
                                   msg=lambda m, p=path: f"{p}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "stoch"])
def test_mnist_train_step_on_the_card_matches_the_cpu(cuda, mode):
    """One full-width mnist_fc step (the paper's recipe, batch 4) on the
    card and on the CPU from the same state and batch: the binarized
    weights are equal, the grads, masters, momentum and batch-norm stats
    within rtol 1e-4 / atol 1e-4 x the tree's largest value."""
    from repro_torch.core import binarize as B
    from repro_torch.launch.train import build_paper_model
    from repro_torch.train import steps as ST

    state, step_fn, batch_fn = build_paper_model("mnist_fc", binarize=mode, device=cuda)
    batch = batch_fn(0)
    cpu_state = {k: (v if k in ("key", "step") else tree_map(lambda t: t.cpu(), v))
                 for k, v in state.items()}
    pol = make_paper_policy(4)
    key = prng.fold_in(state["key"], 0)
    wb = B.binarize_tree(state["params"], mode, pol, key)
    wb_cpu = B.binarize_tree(cpu_state["params"], mode, pol, key)
    for (path, a), (_, b) in zip(tree_leaves_with_path(wb), tree_leaves_with_path(wb_cpu)):
        assert torch.equal(a.cpu(), b), path
    new, m = step_fn(state, batch)
    new_cpu, m_cpu = step_fn(cpu_state, tree_map(lambda t: t.cpu(), batch))
    torch.testing.assert_close(m["loss"].cpu(), m_cpu["loss"], rtol=1e-4, atol=0)
    for name in ("params", "opt", "model_state"):
        _tree_close(new[name], new_cpu[name], 1e-4)


def _vgg_grads(cuda, dtype, tf32_backward=False):
    """Grads of one VGG-16 (width 0.25) det loss at batch 4 on the card, in
    ``dtype``; with ``tf32_backward`` autograd runs outside ``full_f32``
    with cuDNN's TF32 on (PyTorch's default), as a step without the guard
    would."""
    from repro_torch.core import binarize as B
    from repro_torch.models import vgg
    from repro_torch.train import steps as ST

    tree = vgg.init(torch.Generator(device=cuda).manual_seed(0), width_mult=0.25,
                    device=cuda)
    tree = tree_map(lambda t: t.to(dtype), tree)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"x": torch.rand(4, 32, 32, 3, generator=g, device=cuda).to(dtype),
             "y": torch.randint(0, 10, (4,), generator=g, device=cuda)}
    loss_fn = ST.make_classifier_loss(vgg.apply)
    pol = make_paper_policy(3)
    if not tf32_backward:
        return ST.binarized_value_and_grad(loss_fn, tree["params"], batch, mode="det",
                                           policy=pol, key=None,
                                           model_state=tree["state"])[1]
    leaves = [t.detach().requires_grad_(True) for _, t in tree_leaves_with_path(tree["params"])]
    from repro_torch.engine.plan import tree_unflatten

    masters = tree_unflatten(tree["params"], leaves)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss, _ = loss_fn(B.binarize_tree(masters, "det", pol), batch, tree["state"])
        grads = torch.autograd.grad(loss, leaves)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return tree_unflatten(tree["params"], list(grads))


@pytest.mark.cuda
def test_tf32_stays_off_through_vgg_backward(cuda):
    """The train step's VGG grads in f32 on the card stay within 1e-3 x the
    tree's largest grad of the same grads in f64, and closer than a
    backward left to cuDNN's TF32 default."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    want = _vgg_grads(cuda, torch.float64)
    scale = max(float(t.abs().max()) for _, t in tree_leaves_with_path(want))

    def err(tree):
        return max(float((a.double() - b).abs().max()) for (_, a), (_, b) in zip(
            tree_leaves_with_path(tree), tree_leaves_with_path(want)))

    f32 = err(_vgg_grads(cuda, torch.float32))
    tf32 = err(_vgg_grads(cuda, torch.float32, tf32_backward=True))
    assert f32 <= 1e-3 * scale, (f32, scale)
    assert tf32 > f32, (tf32, f32)
    # the step restores the global flags
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic) == flags


@pytest.mark.cuda
def test_train_steps_replay_bit_for_bit_on_the_card(cuda):
    """Two runs of three VGG-16 (width 0.25) det steps from one state give
    the same state bit for bit: cuDNN runs deterministic algorithms."""
    from repro_torch.launch.train import build_paper_model

    def run():
        state, step_fn, batch_fn = build_paper_model("vgg16_cifar10", binarize="det",
                                                     smoke=True, device=cuda)
        for i in range(3):
            state, _ = step_fn(state, batch_fn(i))
        return state

    a, b = run(), run()
    for (path, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert (x == y) if isinstance(x, prng.Key) else torch.equal(x, y), path


# ---------------------------------------------------------------------------
# the dense LM serve (StarCoder2-3B's projection shapes, bf16 activations)
# ---------------------------------------------------------------------------

# (K, N) of StarCoder2-3B's four projections: qkv, w_o, wi, wo
LM_KN = [(3072, 3584), (3072, 3072), (3072, 12288), (12288, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 32])          # decode (4 slots), prefill (32 tokens)
@pytest.mark.parametrize("k,n", [(3072, 3584), (3072, 12288), (12288, 3072),
                                 (768, 3352), (1536, 768)])   # and mamba2-130m's
def test_k2_at_the_lm_shapes_matches_plain(cuda, m, k, n):
    """bf16 activations: products with +-1 are exact and both sides sum in
    f32, so only the sum order differs (f32 tolerance, at K up to 12288)."""
    x, wp, scale = _k2_inputs(m, k, n, torch.bfloat16, True, cuda)
    torch.testing.assert_close(binary_matmul(x, wp, scale), binary_matmul_plain(x, wp, scale),
                               **F32_TOL)


# (K, N) of jamba-1.5-large's projections on the 2-D K2: w_qkv, w_o, the
# Mamba2 in_proj and out_proj, the dense GLU's w_gate / w_up and w_down (K2's
# longest K yet: 768 words over the cluster's 8 slices)
JAMBA_KN = [(8192, 10240), (8192, 8192), (8192, 33280), (16384, 8192), (8192, 24576),
            (24576, 8192)]


def _device_k2_inputs(shape, k, n, device, experts=None):
    """bf16 activations of ``shape``, packed weights (K, N), or (E, K, N)
    with ``experts``, and scales, drawn on the card (numpy would draw up to
    3.2 G weights on the host)."""
    g = torch.Generator(device=device).manual_seed(k + n + sum(shape))
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    lead = () if experts is None else (experts,)
    wp = torch.stack([binarize_pack(torch.randn(k, n, generator=g, device=device),
                                    stochastic=False) for _ in range(experts or 1)])
    scale = torch.rand(lead + (n,), generator=g, device=device) + 0.5
    return x, wp if experts else wp[0], scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 32])          # decode (4 slots), a prefill's 32 tokens
@pytest.mark.parametrize("k,n", JAMBA_KN)
def test_k2_at_jambas_shapes_matches_plain(cuda, m, k, n):
    """K2's tolerance at jamba's projection shapes (bf16 activations: only
    the f32 sum order differs from the plain version), and bit-identical
    output run to run."""
    x, wp, scale = _device_k2_inputs((m, k), k, n, cuda)
    got = binary_matmul(x, wp, scale)
    torch.testing.assert_close(got, binary_matmul_plain(x, wp, scale), **F32_TOL)
    assert all(torch.equal(binary_matmul(x, wp, scale), got) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(4, 12288), (4, 3072), (32, 12288)])
def test_k3_on_bf16_lm_activations(cuda, m, k):
    """Eq. 1 on bf16 activations at the LM's widths, the threshold values
    planted (bf16 has f32's exponent range, so 2^-126 is its threshold too)."""
    x = _acts((m, k), m * k, cuda, torch.bfloat16)
    plants = torch.tensor([2.0 ** -126, -(2.0 ** -126), 2.0 ** -127, -(2.0 ** -133), 1.0],
                          device=cuda).to(torch.bfloat16)
    x[0, 3:3 + plants.numel()] = plants
    got = sign_pack(x)
    assert torch.equal(got, sign_pack_plain(x))
    bits = unpack_activations(got)[0, 3:3 + plants.numel()]
    assert bits.tolist() == [1, -1, -1, -1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("n", [3072, 3584, 12288])
@pytest.mark.parametrize("scaled", [False, True])
def test_k4_at_k_12288(cuda, m, n, scaled):
    """384-word rows (the LM's wo input), exact."""
    a, w = _words((m, 384), m + n, cuda), _words((384, n), n, cuda)
    scale = (torch.from_numpy(np.random.default_rng(n).uniform(0.5, 2, n)
                              .astype(np.float32)).to(cuda) if scaled else None)
    assert torch.equal(xnor_matmul(a, w, scale, k_total=12288),
                       xnor_matmul_plain(a, w, scale, k_total=12288))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 200])
@pytest.mark.parametrize("k", [768, 1536])
@pytest.mark.parametrize("scaled", [False, True])
def test_k4_at_mamba2s_ragged_n(cuda, m, k, scaled):
    """N = 3352 (mamba2-130m's in_proj: 52 x 64 + 24 columns) at 24- and
    48-word rows, exact; M = 200 a prefill past one SSD chunk."""
    n, words = 3352, k // 32
    a, w = _words((m, words), m + k, cuda), _words((words, n), n + k, cuda)
    scale = (torch.from_numpy(np.random.default_rng(k).uniform(0.5, 2, n)
                              .astype(np.float32)).to(cuda) if scaled else None)
    assert torch.equal(xnor_matmul(a, w, scale, k_total=k),
                       xnor_matmul_plain(a, w, scale, k_total=k))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_stacked_k1_pack_matches_the_cpu(cuda, mode):
    """A stacked (L, K, N) leaf packs one K1 launch a layer, and its words
    equal the CPU's plain pack (stoch: the twin's words per layer key)."""
    rng = np.random.default_rng(5)
    tree = {"layers": {"mlp": {"wi": torch.from_numpy(
        rng.normal(size=(3, 3072, 512)).astype(np.float32))}}}
    plan = compile_plan(tree, DEFAULT_POLICY, mode)
    before = binarize_pack.launches
    got = plan.pack(tree_map(lambda t: t.to(cuda), tree), key=prng.key(9))
    assert binarize_pack.launches - before == 3
    want = plan.pack(tree, key=prng.key(9))
    a, b = got["layers"]["mlp"]["wi"], want["layers"]["mlp"]["wi"]
    assert a.packed.shape == (3, 96, 512) and torch.equal(a.packed.cpu(), b.packed)
    torch.testing.assert_close(a.scale.cpu(), b.scale, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_lm_serve_on_the_card(cuda, mode):
    """starcoder2's SMOKE config (2 layers, f32) served on the card: the
    counters are exact (4 projections a layer, per prefill and decode step),
    every stream equals the one-shot generate, and the logits equal the same
    forward with the plain kernels on the card (xnor bit for bit)."""
    counts = (binary_matmul, sign_pack, xnor_matmul)
    before = [f.launches for f in counts]
    res = serve.serve_lm(arch="starcoder2_3b", smoke=True, packed=True, binarize=mode,
                         requests=5, slots=2, prompt_len=8, max_new=3, device="cuda")
    calls = 2 * 4 * (5 + res.steps - 1)          # layers x projections x calls
    got = [f.launches - b for f, b in zip(counts, before)]
    assert got == ([calls, 0, 0] if mode != "xnor" else [0, calls, calls])
    eng = res.engine
    for r in res.batcher.completed:
        assert eng.generate(r.prompt[None], r.max_new).tokens[0].tolist() == r.generated
    prompts = torch.from_numpy(np.stack([r.prompt for r in res.batcher.completed])).to(cuda)
    logits = T.forward(res.cfg, eng.params, prompts)[0]
    saved = (ops._binary_matmul, xops._sign_pack, xops._xnor_matmul)
    ops._binary_matmul, xops._sign_pack, xops._xnor_matmul = (
        binary_matmul_plain, sign_pack_plain, xnor_matmul_plain)
    try:
        plain = T.forward(res.cfg, eng.params, prompts)[0]
    finally:
        ops._binary_matmul, xops._sign_pack, xops._xnor_matmul = saved
    if mode == "xnor":
        assert torch.equal(logits, plain)
    else:
        torch.testing.assert_close(logits, plain, **F32_TOL)


@pytest.mark.cuda
def test_lm_trace_splits_dispatch_and_device_on_the_card(cuda, tmp_path):
    from repro_torch.obs import validate_trace

    res = serve.serve_lm(arch="starcoder2_3b", smoke=True, packed=True, requests=3,
                         slots=2, prompt_len=8, max_new=3, device="cuda",
                         trace=str(tmp_path / "t.json"))
    info = validate_trace(str(tmp_path / "t.json"))
    assert info["root"] == "stream_serve" and info["coverage"] >= 0.95
    names = [e["name"] for e in res.tracer.events]
    assert names.count("device") == names.count("dispatch") > 0



def _smoke_lm(device, mode):
    """starcoder2's SMOKE config packed in ``mode`` on ``device``, and its prompts:
    6 of 8 tokens, the first 6 shared."""
    from repro_torch.configs import base as cb

    cfg = cb.get_config("starcoder2_3b", smoke=True)
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    packed = compile_plan(params, DEFAULT_POLICY, mode).pack(params, key=prng.key(1))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 8)).astype(np.int32)
    prompts[:, :6] = prompts[0, :6]
    return cfg, params, packed, prompts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_lm_chunked_prefix_streams_on_the_card(cuda, mode):
    """Chunked prefill with a prefix cache on the SMOKE config: every stream
    equals the engine's whole-prompt generate, the shared prefix hits, and
    each decode and each chunk runs the 8 projections once (a fused step
    both), so the launches are 8 x (decode steps + chunks)."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve

    cfg, _, packed, prompts = _smoke_lm(cuda, mode)
    eng, pc, reg = ServeEngine(cfg, packed), PrefixCache(), MetricsRegistry()
    b = SlotBatcher(2, 8)
    for p in prompts:
        b.submit(p, 3)
    counter = binary_matmul if mode == "det" else xnor_matmul
    before = counter.launches
    steps = stream_serve(eng, b, prefill_chunk=3, prefix_cache=pc, metrics=reg)
    chunks = reg["serve_prefill_chunks_total"].value
    assert counter.launches - before == 8 * (steps - 1 + chunks)
    assert pc.hits >= 1 and chunks > 0 and len(b.completed) == 6
    for r in b.completed:
        assert eng.generate(r.prompt[None], r.max_new).tokens[0].tolist() == r.generated


@pytest.mark.cuda
def test_lm_ensemble_counters_on_the_card(cuda):
    """A K = 2 ensemble of the SMOKE config: K1 packs 8 leaves a replica, K2
    runs 8 x K a prefill and a decode step, and the stream equals the
    ensemble's generate."""
    from repro_torch.serve import ServeEngine, SlotBatcher, stream_serve

    cfg, params, _, prompts = _smoke_lm(cuda, "stoch")
    plan = compile_plan(params, DEFAULT_POLICY, "stoch")
    before = binarize_pack.launches
    rs = sample_replicas(params, plan, prng.key(1), 2)
    assert binarize_pack.launches - before == 8 * 2
    eng = ServeEngine(cfg, None, ensemble=rs)
    b = SlotBatcher(2, 8)
    for p in prompts[:3]:
        b.submit(p, 3)
    before = binary_matmul.launches
    steps = stream_serve(eng, b)
    assert binary_matmul.launches - before == 8 * 2 * (3 + steps - 1)
    want = eng.generate(prompts[:3], 3)
    for r in b.completed:
        assert r.generated == want.tokens[r.uid].tolist()
        assert all(0.0 <= a <= 1.0 for a in r.agreement)


@pytest.mark.cuda
def test_temperature_words_on_the_card_equal_the_cpu(cuda):
    """The uniform words under categorical, drawn on the card, equal the
    CPU's bit for bit; the gumbel values differ only by the devices' log
    (up to 1.0e-4 measured for u near 1, bounded by ``atol``), and the
    draws agree wherever the margin clears twice that."""
    tiny, atol = torch.finfo(torch.float32).tiny, 2.0 ** -10
    for seed in range(4):
        key = prng.key(seed)
        u_gpu = prng.uniform(key, (4, 49152), cuda, minval=tiny, maxval=1.0)
        u_cpu = prng.uniform(key, (4, 49152), minval=tiny, maxval=1.0)
        assert torch.equal(u_gpu.cpu().view(torch.int32), u_cpu.view(torch.int32))
        g_gpu, g_cpu = prng.gumbel(key, (4, 49152), cuda).cpu(), prng.gumbel(key, (4, 49152))
        torch.testing.assert_close(g_gpu, g_cpu, rtol=0, atol=atol)
        lg = torch.from_numpy(np.random.default_rng(seed).standard_normal((4, 49152))
                              .astype(np.float32))
        top2 = torch.topk(lg + g_cpu, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * atol
        got = prng.categorical(key, lg.to(cuda)).cpu()
        assert torch.equal(got[clear], prng.categorical(key, lg)[clear])


def _batched_inputs(e, m, k, n, dtype, scaled, device):
    rng = np.random.default_rng(e * m + k + n)
    x = torch.from_numpy(rng.normal(size=(e, m, k)).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.normal(size=(e, k, n)).astype(np.float32)).to(device)
    wp = torch.stack([binarize_pack(wi, stochastic=False) for wi in w])
    scale = (torch.from_numpy(rng.uniform(0.5, 2.0, (e, n)).astype(np.float32)).to(device)
             if scaled else None)
    return x, wp, scale


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", [(64, 8, 2048, 1408), (64, 8, 1408, 2048),
                                     (3, 5, 100, 70), (2, 33, 784, 65), (1, 4, 512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [False, True])
def test_batched_k2_matches_plain_and_the_2d_loop(cuda, e, m, k, n, dtype, scaled):
    """The expert-batched K2 at Moonlight's expert shapes (64 experts, the
    decode capacity 8) and ragged ones: within tolerance of its plain
    version, each expert bit for bit the 2-D K2 on its slices, two calls
    bit-identical, one launch a call."""
    x, wp, scale = _batched_inputs(e, m, k, n, dtype, scaled, cuda)
    before = (binary_matmul_batched.launches, binary_matmul.launches)
    got = binary_matmul_batched(x, wp, scale)
    assert (binary_matmul_batched.launches - before[0], binary_matmul.launches - before[1]) \
        == (1, 0)
    torch.testing.assert_close(got, binary_matmul_batched_plain(x, wp, scale),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))
    loop = torch.stack([binary_matmul(x[i], wp[i], None if scale is None else scale[i])
                        for i in range(e)])
    assert torch.equal(got, loop)
    assert torch.equal(binary_matmul_batched(x, wp, scale), got)


def _routings(e, m, seed):
    """Per-expert row counts: every expert empty, one expert full, a decode
    step's 4 tokens x top-6 distinct experts (a seeded draw), and counts
    past M (the kernel clamps them)."""
    g = torch.Generator().manual_seed(seed)
    top = torch.stack([torch.randperm(e, generator=g)[:min(6, e)] for _ in range(4)])
    one = torch.zeros(e, dtype=torch.int64)
    one[e // 2] = m
    return {"all empty": torch.zeros(e, dtype=torch.int64), "one full": one,
            "decode 4 x top-6": torch.bincount(top.reshape(-1), minlength=e),
            "past M": torch.randint(m + 1, 3 * m + 1, (e,), generator=g)}


@pytest.mark.cuda
@pytest.mark.parametrize("e,m,k,n", [(64, 8, 2048, 1408), (64, 8, 1408, 2048),
                                     (3, 5, 100, 70), (2, 9, 16500, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaled", [False, True])
def test_batched_k2_routed_matches_the_2d_loop(cuda, e, m, k, n, dtype, scaled):
    """The expert-batched K2 with ``rows`` (the MoE layer's counts): each
    expert's live rows bit for bit the 2-D K2 on its slices, the rows past
    its count +0 [* scale], two calls bit-identical, one launch a call; at
    Moonlight's expert shapes, a ragged one, and K past 2048 (a chain of
    several word rows, staged in two rounds at K = 16500) with M in two row
    chunks (8 + 1)."""
    x, wp, scale = _batched_inputs(e, m, k, n, dtype, scaled, cuda)
    loop = torch.stack([binary_matmul(x[i], wp[i], None if scale is None else scale[i])
                        for i in range(e)])
    for name, counts in _routings(e, m, seed=e + k).items():
        rows = counts.to(cuda)
        before = (binary_matmul_batched.launches, binary_matmul.launches)
        got = binary_matmul_batched(x, wp, scale, rows)
        assert (binary_matmul_batched.launches - before[0],
                binary_matmul.launches - before[1]) == (1, 0), name
        for i, c in enumerate(counts.clamp(max=m).tolist()):
            assert torch.equal(got[i, :c], loop[i, :c]), (name, i)
            assert (got[i, c:] == 0).all() and not torch.signbit(got[i, c:]).any(), (name, i)
        torch.testing.assert_close(got, binary_matmul_batched_plain(x, wp, scale, rows),
                                   **(F32_TOL if dtype == torch.float32 else BF16_TOL))
        assert torch.equal(binary_matmul_batched(x, wp, scale, rows), got), name


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(8192, 24576), (24576, 8192)])
def test_batched_k2_at_jambas_expert_shapes(cuda, k, n):
    """The expert-batched K2 at jamba's expert shapes (16 experts, the decode
    capacity 8; K = 24576 walks 96 word rows a slice): all rows and each
    routing within tolerance of the plain version, each expert's live rows
    bit for bit the 2-D K2 on its slices and +0 past them, two calls
    bit-identical."""
    e, m = 16, 8
    x, wp, scale = _device_k2_inputs((e, m, k), k, n, cuda, experts=e)
    loop = torch.stack([binary_matmul(x[i], wp[i], scale[i]) for i in range(e)])
    routings = {"all rows": None, **_routings(e, m, seed=e + k)}
    for name, counts in routings.items():
        rows = None if counts is None else counts.to(cuda)
        got = binary_matmul_batched(x, wp, scale, rows)
        live = [m] * e if counts is None else counts.clamp(max=m).tolist()
        for i, c in enumerate(live):
            assert torch.equal(got[i, :c], loop[i, :c]), (name, i)
            assert (got[i, c:] == 0).all() and not torch.signbit(got[i, c:]).any(), (name, i)
        torch.testing.assert_close(got, binary_matmul_batched_plain(x, wp, scale, rows),
                                   **F32_TOL)
        assert torch.equal(binary_matmul_batched(x, wp, scale, rows), got), name


@pytest.mark.cuda
def test_batched_k2_reads_words_off_16_byte_alignment(cuda):
    """Words whose rows are not 16-byte aligned (a contiguous view one word
    into its storage) take the kernel's scalar loads: equal to the aligned
    copy's output."""
    x, wp, scale = _batched_inputs(4, 8, 2048, 1408, torch.bfloat16, True, cuda)
    store = torch.empty(wp.numel() + 1, dtype=torch.int32, device=cuda)
    off = store[1:].view(wp.shape)
    off.copy_(wp)
    rows = torch.tensor([8, 1, 0, 5], device=cuda)
    assert off.data_ptr() % 16 != 0
    assert torch.equal(binary_matmul_batched(x, off, scale, rows),
                       binary_matmul_batched(x, wp, scale, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mode", [("moonshot_v1_16b_a3b", "det"),
                                       ("grok_1_314b", "stoch")])
def test_moe_serve_on_the_card(cuda, arch, mode):
    """An MoE SMOKE config (2 layers, f32) served on the card: 2 attention
    K2 and one batched K2 an expert projection per layer, per prefill and
    decode step; the streams equal one-shot generate, and the logits the
    same forward with the plain kernels."""
    before = (binary_matmul.launches, binary_matmul_batched.launches)
    res = serve.serve_lm(arch=arch, smoke=True, packed=True, binarize=mode, requests=5,
                         slots=2, prompt_len=8, max_new=3, device="cuda")
    calls = 2 * (5 + res.steps - 1)               # layers x model calls
    n_exp = 3 if res.cfg.mlp_type == "glu" else 2
    assert (binary_matmul.launches - before[0],
            binary_matmul_batched.launches - before[1]) == (2 * calls, n_exp * calls)
    eng = res.engine
    for r in res.batcher.completed:
        assert eng.generate(r.prompt[None], r.max_new).tokens[0].tolist() == r.generated
    prompts = torch.from_numpy(np.stack([r.prompt for r in res.batcher.completed])).to(cuda)
    logits = T.forward(res.cfg, eng.params, prompts)[0]
    saved = (ops._binary_matmul, ops._binary_matmul_batched)
    ops._binary_matmul, ops._binary_matmul_batched = (binary_matmul_plain,
                                                      binary_matmul_batched_plain)
    try:
        plain = T.forward(res.cfg, eng.params, prompts)[0]
    finally:
        ops._binary_matmul, ops._binary_matmul_batched = saved
    torch.testing.assert_close(logits, plain, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_ssm_serve_on_the_card(cuda, mode):
    """mamba2-130m's SMOKE config (2 layers, f32) served on the card: in_proj
    and out_proj a layer per prefill and decode step (K2, or K3 + K4), every
    stream equal to its one-shot generate, and the logits the same forward
    with the plain kernels (xnor bit for bit)."""
    counts = (binary_matmul, sign_pack, xnor_matmul)
    before = [f.launches for f in counts]
    res = serve.serve_lm(arch="mamba2_130m", smoke=True, packed=True, binarize=mode,
                         requests=5, slots=2, prompt_len=8, max_new=3, device="cuda")
    calls = 2 * 2 * (5 + res.steps - 1)          # layers x projections x calls
    got = [f.launches - b for f, b in zip(counts, before)]
    assert got == ([calls, 0, 0] if mode != "xnor" else [0, calls, calls])
    eng = res.engine
    for r in res.batcher.completed:
        assert eng.generate(r.prompt[None], r.max_new).tokens[0].tolist() == r.generated
    prompts = torch.from_numpy(np.stack([r.prompt for r in res.batcher.completed])).to(cuda)
    logits = T.forward(res.cfg, eng.params, prompts)[0]
    saved = (ops._binary_matmul, xops._sign_pack, xops._xnor_matmul)
    ops._binary_matmul, xops._sign_pack, xops._xnor_matmul = (
        binary_matmul_plain, sign_pack_plain, xnor_matmul_plain)
    try:
        plain = T.forward(res.cfg, eng.params, prompts)[0]
    finally:
        ops._binary_matmul, xops._sign_pack, xops._xnor_matmul = saved
    if mode == "xnor":
        assert torch.equal(logits, plain)
    else:
        torch.testing.assert_close(logits, plain, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "stoch"])
def test_hybrid_serve_on_the_card(cuda, mode):
    """jamba-1.5-large's SMOKE config (8 layers in 2 periods of 4, f32)
    served on the card: the masters drawn and packed a matrix at a time, the
    words equal to ``plan.pack(init_lm(...))`` on the card; per prefill and
    decode step 14 K2 and 6 expert-batched K2 a period; every stream equal
    to its one-shot generate, and the logits the same forward with the
    plain kernels."""
    before = (binarize_pack.launches, binary_matmul.launches,
              binary_matmul_batched.launches)
    res = serve.serve_lm(arch="jamba_1_5_large", smoke=True, packed=True, binarize=mode,
                         requests=5, slots=2, prompt_len=8, max_new=3, device="cuda")
    calls = 2 * (5 + res.steps - 1)               # periods x model calls
    assert (binarize_pack.launches - before[0], binary_matmul.launches - before[1],
            binary_matmul_batched.launches - before[2]) == (2 * 38, 14 * calls, 6 * calls)
    eng = res.engine
    masters = T.init_lm(res.cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    want = res.plan.pack(masters, key=prng.key(1))
    for (path, a), (_, b) in zip(tree_leaves_with_path(eng.params), tree_leaves_with_path(want)):
        assert type(a) is type(b), path
        assert torch.equal(a.packed if hasattr(a, "packed") else a,
                           b.packed if hasattr(b, "packed") else b), path
    for r in res.batcher.completed:
        assert eng.generate(r.prompt[None], r.max_new).tokens[0].tolist() == r.generated
    prompts = torch.from_numpy(np.stack([r.prompt for r in res.batcher.completed])).to(cuda)
    logits = T.forward(res.cfg, eng.params, prompts)[0]
    saved = (ops._binary_matmul, ops._binary_matmul_batched)
    ops._binary_matmul, ops._binary_matmul_batched = (binary_matmul_plain,
                                                      binary_matmul_batched_plain)
    try:
        plain = T.forward(res.cfg, eng.params, prompts)[0]
    finally:
        ops._binary_matmul, ops._binary_matmul_batched = saved
    torch.testing.assert_close(logits, plain, **F32_TOL)


# ---------------------------------------------------------------------------
# Alg.-1 training of the decoder LMs on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("minval", [1e-6, float(np.nextafter(np.float32(-1), np.float32(0))),
                                    float(np.finfo(np.float32).tiny)])
def test_uniform_with_minval_and_normal_on_the_card_equal_the_cpu(cuda, minval):
    """The twin's single-rounding scale and shift gives the CPU's uniforms on
    the card bit for bit; its normals (f64 log1p and FMA steps) too."""
    k = prng.key(9)
    assert torch.equal(prng.uniform(k, (300, 700), cuda, minval=minval).cpu(),
                       prng.uniform(k, (300, 700), minval=minval))
    assert torch.equal(prng.normal(k, (300, 700), cuda).cpu(), prng.normal(k, (300, 700)))


@pytest.mark.cuda
def test_lm_tokens_and_frontend_stubs_on_the_card_equal_the_cpu(cuda):
    from repro_torch.data import synthetic as syn
    from repro_torch.models import frontends

    spec = syn.SyntheticSpec("lm", batch_size=8, seq_len=128, vocab_size=49152)
    for step in (0, 7):
        assert torch.equal(syn.lm_tokens(spec, step, device=cuda).cpu(),
                           syn.lm_tokens(spec, step, device="cpu"))
    for stub in frontends.STUBS.values():
        got = stub(prng.key(3), 2, 16, 64, device=cuda)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), stub(prng.key(3), 2, 16, 64))


def _lm_steps(arch, mode, device, n=1, start=None):
    """(start state, [(new state, metrics)] a step) of ``n`` SMOKE LM steps
    through ``build_lm`` on ``device`` (from ``start``, moved there, when
    given); a frontend arch trains on its stub's embeddings."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.train import build_lm
    from repro_torch.models import frontends

    state, step_fn, batch_fn = build_lm(arch, binarize=mode, smoke=True, batch=4, seq=16,
                                        device=device)
    if start is not None:
        state = {k: (v if k in ("key", "step") else tree_map(lambda t: t.to(device), v))
                 for k, v in start.items()}
    cfg = cb.get_config(arch, smoke=True)
    out, start = [], state
    for i in range(n):
        batch = batch_fn(i)
        if cfg.frontend:
            batch = {"tokens": frontends.STUBS[cfg.frontend](prng.key(i), 4, 16, cfg.d_model,
                                                              device=device),
                     "labels": batch["tokens"][:, 1:]}
        state, m = step_fn(state, batch)
        out.append((state, m))
    return start, out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "stoch"])
@pytest.mark.parametrize("arch", ["starcoder2_3b", "moonshot_v1_16b_a3b", "mamba2_130m",
                                  "jamba_1_5_large", "musicgen_large"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch, mode):
    """One SMOKE LM step (f32) on the card and on the CPU from the same
    masters and batch: loss, xent and lb_loss within rtol 1e-4; momentum
    (the step's grads) within 2e-5 + 1e-2 x the leaf's largest |grad|, and
    the masters within the same x the leaf's largest update, as the CPU
    parity tests hold the port to the reference (f32 grads through +-1
    weights are that sensitive to the order of their sums); no port kernel
    launches."""
    names = (binary_matmul, binarize_pack, sign_pack, xnor_matmul)
    before = [f.launches for f in names]
    start, [(new, m)] = _lm_steps(arch, mode, cuda)
    assert [f.launches for f in names] == before
    _, [(new_cpu, m_cpu)] = _lm_steps(arch, mode, "cpu", start=start)
    for k in ("loss", "xent", "lb_loss"):
        torch.testing.assert_close(m[k].cpu(), m_cpu[k], rtol=1e-4, atol=1e-7)
    old = dict(tree_leaves_with_path(start["params"]))
    for name, got, want in (("mu", new["opt"]["mu"], new_cpu["opt"]["mu"]),
                            ("params", new["params"], new_cpu["params"])):
        for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
            scale = float((b if name == "mu" else b - old[path].cpu()).abs().max())
            err = float((a.cpu().double() - b.double()).abs().max())
            assert err <= 2e-5 + 1e-2 * scale, (name, path, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_130m"])
def test_lm_train_steps_replay_bit_for_bit_on_the_card(cuda, arch):
    """Two runs of three SMOKE LM steps from one seed end bit for bit equal
    (the embedding's backward sums a repeated token's rows in order)."""
    a = _lm_steps(arch, "stoch", cuda, 3)[1][-1][0]
    b = _lm_steps(arch, "stoch", cuda, 3)[1][-1][0]
    for (path, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b)):
        assert (x == y) if isinstance(x, prng.Key) else torch.equal(x, y), path


@pytest.mark.cuda
def test_lm_remat_changes_no_grad_on_the_card(cuda):
    """Remat "full" and "dots" give the grads of "none" on the card too."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.launch.train import build_lm
    from repro_torch.train import steps as ST

    state, _, batch_fn = build_lm("jamba_1_5_large", smoke=True, batch=4, seq=16, device=cuda)
    cfg = cb.get_config("jamba_1_5_large", smoke=True)
    grads = {}
    for remat in ("none", "full", "dots"):
        grads[remat] = ST.binarized_value_and_grad(
            ST.make_lm_loss(dataclasses.replace(cfg, remat=remat)), state["params"],
            batch_fn(0), mode="det", policy=DEFAULT_POLICY, key=None)[1]
    for remat in ("full", "dots"):
        for (path, a), (_, b) in zip(tree_leaves_with_path(grads[remat]),
                                     tree_leaves_with_path(grads["none"])):
            assert torch.equal(a, b), (remat, path)


# ---------------------------------------------------------------------------
# serving on a mesh whose positions share the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_mesh_stream_equals_single_device_on_the_card(cuda, mode):
    """starcoder2's SMOKE config on a (2, 2) ("data", "model") mesh whose four
    positions share the card: every stream equals the single-device
    engine's, each decode step launches each projection once a position
    (4 x 4 x 2 a step: K2, or K3 and K4), and its collectives are the
    plan's prediction."""
    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as SH
    from repro_torch.obs.collectives import predict_call_collectives
    from repro_torch.serve import ServeEngine, SlotBatcher, stream_serve

    cfg = cb.get_config("starcoder2_3b", smoke=True)
    mesh = SH.Mesh((2, 2), ("data", "model"), device="cuda")
    assert all(d == torch.device("cuda", p % torch.cuda.device_count())
               for p, d in enumerate(mesh.devices.flat))
    params = T.init_lm(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    plan = compile_plan(params, DEFAULT_POLICY, mode, mesh=mesh)
    packed = plan.pack(params)

    def run(engine):
        rng = np.random.default_rng(0)
        b = SlotBatcher(4, 8)
        for m in (3, 5, 2, 4, 3, 4):
            b.submit(rng.integers(0, cfg.vocab_size, 8), m)
        stream_serve(engine, b, max_new_cap=5)
        return {r.uid: r.generated for r in b.completed}

    eng = ServeEngine(cfg, packed, mesh=mesh, plan=plan)
    assert run(eng) == run(ServeEngine(cfg, packed))
    state = eng.init_decode(4, 8, 4)
    for s in range(4):
        state = eng.prefill_into(state, s, np.arange(8) + s)
    counts = (binary_matmul, sign_pack, xnor_matmul)
    before = [f.launches for f in counts]
    SH.reset_collective_counts()
    eng.decode_step(state, np.zeros(4, np.int32))
    calls = 4 * 4 * cfg.n_layers
    got = [f.launches - b for f, b in zip(counts, before)]
    assert got == ([calls, 0, 0] if mode == "det" else [0, calls, calls])
    assert SH.collective_counts() == predict_call_collectives(plan, mesh.axis_sizes(), groups=2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_model", [2, 4])
def test_xnor_row_partials_are_exact_on_the_card(cuda, n_model):
    """A row-parallel xnor projection at StarCoder2's w_down shape (12288 x
    3072) and smoke's: each range's int32 K3 + K4 partial, summed, then
    scaled once, equals the unsharded K4 with its scale bit for bit."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.layers import XnorLinear, apply_linear

    for m, k, n in ((4, 12288, 3072), (3, 512, 128)):
        w, _ = _weights(k, n, k + n, cuda)
        x = torch.randn(m, k, generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda, dtype=torch.bfloat16)
        words, scale = ops.binarize_and_pack(w), w.abs().mean(0)
        want = xops.xnor_matmul(x, words, scale, k=k, out_dtype=torch.float32).to(x.dtype)
        mesh = SH.Mesh((1, n_model), ("data", "model"), device="cuda")
        leaf = XnorLinear(words, scale, k)
        view = SH.group_view(SH.place_packed_params(mesh, {"w_o": leaf}), 0)["w_o"]
        assert torch.equal(apply_linear(view, x), want)


@pytest.mark.cuda
def test_a_cuda_mesh_without_a_card_raises(cuda, monkeypatch):
    from repro_torch.distributed import sharding as SH

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        SH.Mesh((2, 2), ("data", "model"))
