"""The port's CUDA kernels against their plain versions, and the rules that
keep a CUDA tensor from reaching a plain version.

Tests marked ``cuda`` need an NVIDIA GPU and nvcc; they decide inside the
test whether a card is present and skip here otherwise. This file imports
neither JAX nor the reference package, so it also runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.binary_matmul import binary_matmul, binary_matmul_plain
from repro_torch.kernels.stoch_binarize import binarize_pack, binarize_pack_plain
from repro_torch.launch import serve

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
def test_launch_counters_count_kernel_launches(cuda):
    w, bits = _weights(64, 128, 0, cuda)
    k1, k2 = binarize_pack.launches, binary_matmul.launches
    wp = ops.binarize_and_pack(w, bits, stochastic=True)
    ops.binary_matmul(torch.ones(2, 3, 64, device=cuda), wp)
    assert (binarize_pack.launches - k1, binary_matmul.launches - k2) == (1, 1)


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
