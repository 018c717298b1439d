"""Port parity for the fully-binary FC path: activation packing, K3's and K4's
plain versions against the reference's Pallas kernels (interpret mode) and
jit'd ops, and mnist_fc ``xnor`` from carried-across packed trees.

Integer datapaths are exact: words and popcount dots must be equal. Inputs
are made with numpy from a seed and handed to both packages. End-to-end
logits hold f32 rtol 1e-4 / atol 1e-3 (the dense layers and batch norm sum
in another order), and the test counts the positions whose sign activation
differs between the two forwards (expected 0 at these seeds).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.engine import compile_plan as j_compile_plan
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models.layers import XnorLinear as JXnorLinear
from repro.models.layers import apply_linear as j_apply_linear
from repro.serve.engine import packed_param_bytes as j_packed_param_bytes
from repro.xnor import ops as jxops
from repro.xnor import packing as jpack
from repro.xnor import ref as jxref
from repro.xnor.kernel import sign_pack_pallas, xnor_matmul_pallas
from repro_torch.core.policy import make_paper_policy
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import mnist_fc
from repro_torch.models.layers import XnorLinear, apply_linear
from repro_torch.xnor import ops, ref
from repro_torch.xnor import packing as P
from repro_torch.xnor.kernel import sign_pack, xnor_matmul

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks" / "golden_plans"
F32_TOL = dict(rtol=1e-4, atol=1e-3)
INT32_EDGES = np.array([0, -1, -(2**31), 2**31 - 1, 1, 0x55555555, -0x55555556],
                       np.int32)


def _ceil(a, b):
    return -(-a // b) * b


def _acts(m, k, seed, dtype=np.float32):
    """Normal activations with 0.0, -0.0, NaN and +-inf planted."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=min(flat.size, 10), replace=False)
    flat[idx] = np.resize(np.array([0.0, -0.0, np.nan, np.inf, -np.inf], np.float32),
                          len(idx))
    return x.astype(dtype)


def _words(shape, seed):
    """Uniform int32 words over all 32 bits, with the edge patterns planted."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    w.reshape(-1)[: min(w.size, INT32_EDGES.size)] = INT32_EDGES[: w.size]
    return w


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_popcount_is_exact_on_the_edges():
    words = torch.from_numpy(INT32_EDGES)
    got = P.popcount(words).tolist()
    assert got[:4] == [0, 32, 1, 31]
    assert P.popcount(words).dtype == torch.int32
    rand = _words((64, 33), 1)
    want = np.asarray(jpack.popcount(jnp.asarray(rand)))
    np.testing.assert_array_equal(P.popcount(torch.from_numpy(rand)).numpy(), want)


@pytest.mark.parametrize("m,k", [(1, 32), (4, 64), (7, 320), (3, 100)])
def test_activation_packing_matches_reference(m, k):
    x = _acts(m, k, m * k)
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(P.pad_features(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpack.pad_features(jx)))
    xp = P.pad_features(torch.from_numpy(x))
    words = P.pack_activations(xp)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jpack.pack_activations(jpack.pad_features(jx))))
    np.testing.assert_array_equal(P.unpack_activations(words).numpy(),
                                  np.asarray(jpack.unpack_activations(jnp.asarray(words))))
    assert P.activation_nbytes((m, k)) == jpack.activation_nbytes((m, k))
    assert P.packed_activation_nbytes((m, k)) == jpack.packed_activation_nbytes((m, k))
    with pytest.raises(ValueError, match="multiple"):
        P.pack_activations(torch.zeros(2, 33))


# ---------------------------------------------------------------------------
# K3: sign + pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k", [(128, 512), (200, 544), (8, 31), (3, 100), (4, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_matches_pallas_kernel_and_ops(m, k, dtype):
    x = _acts(m, k, m + k)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = sign_pack(tx)
    assert got.dtype == torch.int32 and got.shape == (m, -(-k // 32))
    mp, kp = _ceil(m, 8), _ceil(k, 512)
    jxp = jnp.pad(jx, ((0, mp - m), (0, kp - k)))
    want = np.asarray(sign_pack_pallas(jxp, block_m=8, block_k=512, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want[:m, : -(-k // 32)])
    np.testing.assert_array_equal(ops.sign_and_pack(tx).numpy(),
                                  np.asarray(jxops.sign_and_pack(jx)))


def test_k3_sign_convention():
    """0.0, -0.0 and NaN give bit 0, as ``x > 0`` does (Eq. 1)."""
    x = torch.tensor([[0.0, -0.0, float("nan"), 1e-30, -1e-30] + [0.0] * 27])
    assert sign_pack(x).tolist() == [[0b01000]]
    assert int(sign_pack(torch.ones(1, 32))[0, 0]) == -1     # bit 31 is the sign bit


# ---------------------------------------------------------------------------
# K4: XNOR-popcount matmul
# ---------------------------------------------------------------------------

def _pallas_xnor(a, w, k, scale=None):
    """The reference kernel in interpret mode on a block-padded copy (0 words
    on both sides cancel)."""
    m, words = a.shape
    n = w.shape[1]
    mp, wp_, np_ = _ceil(m, 8), _ceil(words, 16), _ceil(n, 128)
    ap = np.zeros((mp, wp_), np.int32)
    ap[:m, :words] = a
    wpad = np.zeros((wp_, np_), np.int32)
    wpad[:words, :n] = w
    sp = None
    if scale is not None:
        sp = np.zeros(np_, np.float32)
        sp[:n] = scale
        sp = jnp.asarray(sp)
    out = xnor_matmul_pallas(jnp.asarray(ap), jnp.asarray(wpad), sp, k_total=k,
                             block_m=8, block_n=128, block_k=512, interpret=True)
    return np.asarray(out)[:m, :n]


# (M, K, N): the serving shapes' kinds (M=4 FC, conv im2col rows), ragged
# M/N, K not a multiple of 32
XNOR_SHAPES = [(4, 2048, 256), (64, 576, 128), (33, 100, 65), (5, 7, 3), (16, 1152, 40)]


@pytest.mark.parametrize("m,k,n", XNOR_SHAPES)
@pytest.mark.parametrize("scaled", [False, True])
def test_k4_matches_pallas_kernel_and_ops(m, k, n, scaled):
    words = -(-k // 32)
    a, w = _words((m, words), m + k), _words((words, n), k + n)
    scale = (np.random.default_rng(n).uniform(0.5, 2.0, n).astype(np.float32)
             if scaled else None)
    ts = None if scale is None else torch.from_numpy(scale)
    got = xnor_matmul(torch.from_numpy(a), torch.from_numpy(w), ts, k_total=k)
    assert got.dtype == (torch.float32 if scaled else torch.int32)
    np.testing.assert_array_equal(got.numpy(), _pallas_xnor(a, w, k, scale))
    want = jxops.xnor_matmul_packed(jnp.asarray(a), jnp.asarray(w),
                                    None if scale is None else jnp.asarray(scale), k=k)
    np.testing.assert_array_equal(
        ops.xnor_matmul_packed(torch.from_numpy(a), torch.from_numpy(w), ts, k=k).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("c", [16, 40, 64])
def test_k4_allow_extra_words(c):
    """Per-tap channel padding: surplus words are 0 bits on both sides."""
    taps, n, m = 9, 48, 20
    rng = np.random.default_rng(c)
    cw = -(-c // 32)
    a = np.zeros((m, taps, cw * 32), np.float32)
    w = np.full((taps, cw * 32, n), -1.0, np.float32)
    a[:, :, :c] = rng.normal(size=(m, taps, c))
    w[:, :c] = rng.normal(size=(taps, c, n))
    ap = np.array(jpack.pack_activations(jnp.asarray(a.reshape(m, -1))))
    wp = np.asarray(jxref.sign_pack_ref(jnp.asarray(w.reshape(-1, n).T))).T.copy()
    k = taps * c
    want = np.asarray(jxops.xnor_matmul_packed(jnp.asarray(ap), jnp.asarray(wp), k=k,
                                               allow_extra_words=True))
    got = ops.xnor_matmul_packed(torch.from_numpy(ap), torch.from_numpy(wp), k=k,
                                 allow_extra_words=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _pallas_xnor(ap, wp, k))
    if cw * 32 != c:
        with pytest.raises(ValueError, match="inconsistent"):
            ops.xnor_matmul_packed(torch.from_numpy(ap), torch.from_numpy(wp), k=k)


@pytest.mark.parametrize("m,k,n", [(128, 512, 128), (129, 100, 65), (5, 7, 3)])
def test_xnor_matmul_three_way_exact(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    from repro_torch.kernels.ops import binarize_and_pack
    wp = binarize_and_pack(torch.from_numpy(w))
    got = ops.xnor_matmul(torch.from_numpy(x), wp, k=k)
    dense = ref.sign_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), dense.numpy().astype(np.int32))
    np.testing.assert_array_equal(ref.xnor_forward_ref(torch.from_numpy(x), wp, k).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jxref.xnor_forward_ref(jnp.asarray(x), jnp.asarray(wp), k)))
    lead = ops.xnor_matmul(torch.from_numpy(x).reshape(1, m, k), wp, k=k)
    assert lead.shape == (1, m, n)


def test_word_count_checks_match_reference():
    a = torch.zeros(2, 4, dtype=torch.int32)
    w = torch.zeros(4, 8, dtype=torch.int32)
    for kw in [dict(k=64), dict(k=129), dict(k=96, allow_extra_words=False)]:
        with pytest.raises(ValueError):
            ops.xnor_matmul_packed(a, w, **kw)
        with pytest.raises(ValueError):
            jxops.xnor_matmul_packed(jnp.asarray(a.numpy()), jnp.asarray(w.numpy()), **kw)
    assert ops.xnor_matmul_packed(a, w, k=64, allow_extra_words=True).shape == (2, 8)
    with pytest.raises(ValueError, match="mismatch"):
        ops.xnor_matmul_packed(a, torch.zeros(3, 8, dtype=torch.int32), k=96)
    with pytest.raises(ValueError, match="declared"):
        ops.xnor_matmul(torch.zeros(2, 100), w, k=128)


def test_xnor_linear_layer_matches_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 256)).astype(np.float32)
    wp = _words((8, 64), 4)
    s = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    want = np.asarray(j_apply_linear(JXnorLinear(jnp.asarray(wp), jnp.asarray(s), 256),
                                     jnp.asarray(x)))
    got = apply_linear(XnorLinear(torch.from_numpy(wp), torch.from_numpy(s), 256),
                       torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the slice: mnist_fc xnor
# ---------------------------------------------------------------------------

def test_mnist_xnor_plan_matches_golden():
    golden = json.loads((GOLDEN / "mnist_fc_xnor.json").read_text())
    tree = mnist_fc.init(torch.Generator().manual_seed(0), device="cpu")
    plan = compile_plan(tree["params"], make_paper_policy(4), "xnor")
    assert plan.mode == golden["mode"] == "xnor"
    assert len(plan.layers) == len(golden["layers"])
    assert plan.to_json() == golden          # the whole manifest, sharding column included
    assert [a.path for a in plan.assignments("xnor")] == ["layers/1/kernel",
                                                          "layers/2/kernel"]


def _jax_mnist(seed, hidden):
    """Reference mnist_fc with numpy-made bias, batch-norm parameters and
    running stats, so every layer matters."""
    tree = jfc.init(jax.random.key(seed), hidden=hidden)
    rng = np.random.default_rng(seed)
    for lp, ls in zip(tree["params"]["layers"], tree["state"]["layers"]):
        b = lp["bias"].shape[0]
        lp["bias"] = jnp.asarray(rng.normal(0, 0.1, b).astype(np.float32))
        lp["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, b).astype(np.float32))
        lp["bn_bias"] = jnp.asarray(rng.normal(0, 0.1, b).astype(np.float32))
        ls["mean"] = jnp.asarray(rng.normal(0, 0.5, b).astype(np.float32))
        ls["var"] = jnp.asarray(rng.uniform(0.5, 4.0, b).astype(np.float32))
    return tree


def record_signs(monkeypatch, jax_module, port_module):
    """Records the sign activations on both sides (on the port's side those
    of its ``bn_sign`` sites, and the signs its fused K3 sites pack, read
    back from the words); returns a function counting the positions whose
    sign differs."""
    from repro_torch.models.layers import bn_sign, bn_sign_words

    seen = {"jax": [], "port": []}
    j_binarize = jax_module.binarize

    def j_rec(x, mode, *a, **k):
        out = j_binarize(x, mode, *a, **k)
        seen["jax"].append(np.asarray(out) > 0)
        return out

    def p_rec(x, *vecs):
        out = bn_sign(x, *vecs)
        seen["port"].append((out > 0).numpy())
        return out

    def p_rec_fused(x, *vecs):
        sw = bn_sign_words(x, *vecs)
        seen["port"].append((P.unpack_activations(sw.words)[..., : sw.k] > 0).numpy())
        return sw

    monkeypatch.setattr(jax_module, "binarize", j_rec)
    monkeypatch.setattr(port_module, "bn_sign", p_rec)
    monkeypatch.setattr(port_module, "bn_sign_words", p_rec_fused)

    def flips():
        assert len(seen["jax"]) == len(seen["port"]) > 0
        return sum(int((a != b).sum()) for a, b in zip(seen["jax"], seen["port"]))

    return flips


def test_mnist_xnor_logits_match_reference_at_full_width(monkeypatch):
    tree = _jax_mnist(1, (2048, 2048, 2048))
    plan = j_compile_plan(tree["params"], j_make_paper_policy(4), "xnor")
    packed = plan.pack(tree["params"])
    x = np.random.default_rng(2).uniform(0, 1, (4, 784)).astype(np.float32)
    flips = record_signs(monkeypatch, jfc, mnist_fc)
    want = np.asarray(jfc.apply(packed, tree["state"], jnp.asarray(x), training=False,
                                binary_act=True)[0])
    port_params = from_jax_tree(jax.tree_util.tree_map(np.asarray, packed), device="cpu")
    port_state = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree["state"]),
                               device="cpu")
    kinds = {p: type(leaf) for p, leaf in tree_leaves_with_path(port_params)}
    assert kinds["layers/1/kernel"] is XnorLinear and kinds["layers/2/kernel"] is XnorLinear
    got = mnist_fc.apply(port_params, port_state, torch.from_numpy(x), binary_act=True)
    assert flips() == 0
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert j_packed_param_bytes(packed) == serve.packed_param_bytes(port_params)


def test_mnist_xnor_pack_matches_reference_words():
    tree = _jax_mnist(3, (128, 128, 128))
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(4), "xnor").pack(
        tree["params"])
    master = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree["params"]), device="cpu")
    packed = compile_plan(master, make_paper_policy(4), "xnor").pack(master)
    for i in (1, 2):
        got, want = packed["layers"][i]["kernel"], jpacked["layers"][i]["kernel"]
        assert isinstance(got, XnorLinear) and got.k == want.k
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)


def test_serve_cli_xnor_on_cpu(capsys):
    res = serve.main(["--device", "cpu", "--smoke", "--binarize", "xnor",
                      "--requests", "8"])
    assert "packed weights (xnor)" in capsys.readouterr().out
    assert isinstance(res.params["layers"][1]["kernel"], XnorLinear)
    assert res.last_logits.shape == (4, 10) and torch.isfinite(res.last_logits).all()
