"""Port parity for K3 with its producer prologue (``bn_sign_pack``: bias,
eval batch norm and Eq.-1 sign folded into K3's load) and for the route that
sends it sign words.

The plain version is the chain flushed where the reference's XLA CPU
flushes (``bn_sign_plain``), so on the same numpy inputs its words equal,
bit for bit, the reference's chain: ``batch_norm`` (eval),
``binarize(., "det")``, then ``sign_and_pack`` (the Pallas kernel in
interpret mode, or its plain reference for tiny shapes, as the reference's
own tests run it on the CPU). Logits through the fused route hold the
existing xnor tests' f32 rtol 1e-4 / atol 1e-3, with no sign activation
differing from the reference's.

Eq. 1's threshold (``core.binarize.SIGN_MIN`` = 2^-126): a subnormal signs
-1, as the reference's XLA CPU reads it as zero. The sign sites of the port
(``deterministic_binarize``, K1's det pack, K3 plain and with its prologue,
K5) equal the reference's on values either side of it, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core.binarize import binarize as j_binarize
from repro.core.binarize import deterministic_binarize as j_deterministic_binarize
from repro.kernels.ref import det_binarize_pack_ref as j_det_binarize_pack_ref
from repro.engine import compile_plan as j_compile_plan
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models import vgg as jvgg
from repro.models.layers import batch_norm as j_batch_norm
from repro.xnor import ops as jxops
from repro.xnor.conv import ops as jcops
from repro_torch.core.binarize import SIGN_MIN, deterministic_binarize
from repro_torch.engine import registry
from repro_torch.interop import from_jax_tree
from repro_torch.models import mnist_fc, vgg
from repro_torch.models.layers import (PackedLinear, SignWords, XnorLinear, apply_linear,
                                       batch_norm, bn_sign, bn_sign_words, takes_sign_words)
from repro_torch.xnor import cases
from repro_torch.xnor import ops as xops
from repro_torch.core.packing import unpack_bits
from repro_torch.kernels.ref import det_binarize_pack_ref
from repro_torch.xnor.conv.ops import sign_and_pack_patches
from repro_torch.xnor.kernel import bn_sign_pack, bn_sign_pack_plain, sign_pack

from test_torch_vgg import _jax_vgg
from test_torch_xnor import _jax_mnist, record_signs

F32_TOL = dict(rtol=1e-4, atol=1e-3)


def _jax_chain_words(case):
    """The reference's chain on the same inputs: bias add, eval batch norm,
    Eq.-1 sign, sign_and_pack (Pallas in interpret mode past 8 x 128)."""
    h, bias, scale, shift, mean, var = (jnp.asarray(t.numpy()) for t in case)
    y = j_batch_norm(h + bias.astype(h.dtype), scale, shift, mean, var, training=False)[0]
    return np.asarray(jxops.sign_and_pack(j_binarize(y, "det"), block_m=8, block_k=128))


def _bits(words, k):
    """(M, K) 0/1 sign bits of (M, ceil(K/32)) words."""
    return ((words[:, :, None] >> torch.arange(32)) & 1).reshape(words.shape[0], -1)[:, :k]


@pytest.mark.parametrize("m,k", [(4, 2048), (4, 512), (7, 100), (3, 31)])
def test_plain_matches_reference_chain_bit_for_bit(m, k):
    case = cases.bn_inputs(m, k, m * k, "cpu", subnormals=False)
    got = bn_sign_pack_plain(*case)
    assert got.shape == (m, -(-k // 32)) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_chain_words(case))
    # the planted BN outputs: +0, -0.0, NaN, -1 and 0 * inf give bit 0, +1 bit 1
    bits = _bits(got, k)
    for c in range(min(k, 16)):
        want = {0: 0, 1: 0, 2: 0, 3: 1, 4: 0, 5: 0}.get(c % 16)
        if want is not None:
            assert bits[:, c].tolist() == [want] * m, c


def test_a_subnormal_bn_output_is_where_the_reference_flushes():
    """A BN output of +-2^-149 is below Eq. 1's threshold 2^-126, so it
    signs -1 in the port, as in the reference, whose XLA CPU flushes it to
    0: the port's words equal the reference's at every column, the
    +2^-149 plants (columns 3, 19, 35, 51) included."""
    case = cases.bn_inputs(4, 64, 1, "cpu")
    port, ref = _bits(bn_sign_pack_plain(*case), 64), _bits(
        torch.from_numpy(_jax_chain_words(case).copy()), 64)
    assert torch.equal(port, ref)
    assert not bool(port[:, [3, 19, 35, 51]].any())


def test_a_subnormal_bn_intermediate_is_where_the_reference_flushes():
    """The smallest case of the fault once open in ROADMAP queue 3: h + bias
    - mean = 2^-130 is subnormal, and times inv_std = 1 and scale = 2^20
    gives y = 2^-110, a normal positive. The reference's XLA CPU flushes the
    intermediate to 0 and signs -1; the port's chain flushes it too."""
    f32 = np.float32
    var = f32(1) - f32(1e-5)                          # var + eps == 1.0 in f32
    case = tuple(torch.tensor(a, dtype=torch.float32) for a in (
        [[2.0 ** -125]], [0.0], [2.0 ** 20], [0.0], [31 * 2.0 ** -130], [var]))
    assert float(case[0][0, 0] - case[4][0]) == 2.0 ** -130
    assert bn_sign_pack_plain(*case).tolist() == [[0]]
    assert _jax_chain_words(case).tolist() == [[0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eq1_threshold_matches_reference_at_every_sign_site(dtype):
    """Values either side of 2^-126 (``cases.sign_plants``: subnormals of
    both signs, 2^-126 and the next value, -2^-126, +-0, NaN) sign as in
    the reference through ``deterministic_binarize``, the det pack (K1's
    plain version), plain K3 and K5's plain version, exactly."""
    vals, bits = cases.sign_plants(dtype)
    assert torch.equal((vals.float() >= SIGN_MIN).long(), bits)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jdt)

    got = deterministic_binarize(vals)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(j_deterministic_binarize(j(vals))).astype(np.float32))
    assert torch.equal((got > 0).long(), bits)
    w = torch.randn(128, 40, generator=torch.Generator().manual_seed(5)).to(dtype)
    want = cases.plant_signs(w, 0)
    np.testing.assert_array_equal(det_binarize_pack_ref(w).numpy(),
                                  np.asarray(j_det_binarize_pack_ref(j(w))))
    assert torch.equal((unpack_bits(det_binarize_pack_ref(w)) > 0).long().T[:, want >= 0],
                       want[want >= 0].expand(40, -1))
    x = torch.randn(5, 100, generator=torch.Generator().manual_seed(6)).to(dtype)
    cases.plant_signs(x, 1)
    np.testing.assert_array_equal(sign_pack(x).numpy(),
                                  np.asarray(jxops.sign_and_pack(j(x), block_m=8, block_k=128)))
    x = torch.randn(2, 5, 6, 40, generator=torch.Generator().manual_seed(7)).to(dtype)
    cases.plant_signs(x, 3)
    np.testing.assert_array_equal(
        sign_and_pack_patches(x, ksize=(3, 3)).numpy(),
        np.asarray(jcops.sign_and_pack_patches(j(x), ksize=(3, 3))))


@pytest.mark.parametrize("m,k", [(4, 2048), (4, 512), (7, 100)])
def test_eq1_threshold_at_the_fused_sites_matches_reference(m, k):
    """The plants as BN outputs (``cases.plant_bn_signs``): K3's plain
    prologue chain gives the reference chain's words, and Eq. 1's bits."""
    case, want = cases.plant_bn_signs(cases.bn_inputs(m, k, 40 + k, "cpu"))
    got = bn_sign_pack_plain(*case)
    np.testing.assert_array_equal(got.numpy(), _jax_chain_words(case))
    bits = _bits(got, k)
    assert torch.equal(bits[:, want >= 0].long(), want[want >= 0].expand(m, -1))


@pytest.mark.parametrize("m,k", cases.FUSED_SHAPES)
def test_wrapper_on_cpu_is_the_plain_chain(m, k):
    """On the CPU the wrapper runs the plain version, launches nothing and
    equals the model's unfused ops (``bn_sign``, then K3), and here, with no
    subnormal intermediate, the eager chain, near-zero plants included."""
    case = cases.plant_near_zero(cases.bn_inputs(m, k, m + k, "cpu"))
    before = (sign_pack.launches, sign_pack.launches_fused)
    got = bn_sign_pack(*case)
    h, bias, scale, shift, mean, var = case
    assert torch.equal(got, sign_pack(bn_sign(*case)))
    want = sign_pack(deterministic_binarize(batch_norm(h + bias, scale, shift, mean, var)))
    assert torch.equal(got, want)
    assert (sign_pack.launches, sign_pack.launches_fused) == before
    lead = xops.bn_sign_and_pack(h.reshape(1, m, k), *case[1:])
    assert torch.equal(lead, got.reshape(1, m, -1))


def test_sign_words_feed_the_xnor_leaf_like_the_chain():
    """An XnorLinear fed the fused SignWords gives the logits it gives the
    +-1 activation of the unfused site (``bn_sign``), bit for bit."""
    h, bias, scale, shift, mean, var = cases.bn_inputs(4, 100, 9, "cpu")
    rng = np.random.default_rng(10)
    leaf = XnorLinear(torch.from_numpy(rng.integers(-2**31, 2**31, (4, 24), dtype=np.int64)
                                       .astype(np.int32)),
                      torch.from_numpy(rng.uniform(0.5, 2.0, 24).astype(np.float32)), 100)
    sw = bn_sign_words(h, bias, scale, shift, mean, var)
    assert isinstance(sw, SignWords) and sw.k == 100
    chain = bn_sign(h, bias, scale, shift, mean, var)
    assert torch.equal(apply_linear(leaf, sw), apply_linear(leaf, chain))
    with pytest.raises(ValueError, match="k=100"):
        apply_linear(XnorLinear(leaf.packed, leaf.scale, 99), sw)


def test_only_the_xnor_backend_takes_sign_words():
    assert [s.name for s in registry.backends("linear") if s.takes_sign_words] == ["xnor"]
    w = torch.zeros(32, 8)
    assert takes_sign_words(XnorLinear(torch.zeros(1, 8, dtype=torch.int32), None, 32))
    assert not takes_sign_words(PackedLinear(torch.zeros(1, 8, dtype=torch.int32), None, 32))
    assert not takes_sign_words(w)


def _count_routes(monkeypatch, module):
    """Counts the model's fused sites and its unfused (``bn_sign``) sign
    activations."""
    seen = {"fused": 0, "chain": 0}
    fused, chain = module.bn_sign_words, module.bn_sign

    def count_fused(*a):
        seen["fused"] += 1
        return fused(*a)

    def count_chain(*a):
        seen["chain"] += 1
        return chain(*a)

    monkeypatch.setattr(module, "bn_sign_words", count_fused)
    monkeypatch.setattr(module, "bn_sign", count_chain)
    return seen


# mnist_fc: layers/0->1 and 1->2 fused, 2->3 (dense) not; VGG: fc/0->1 fused,
# the 11 conv sign sites and fc/1->2 not
ROUTES = {"mnist_fc": {"fused": 2, "chain": 1}, "vgg16_cifar10": {"fused": 1, "chain": 12}}


@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
def test_fused_route_logits_match_reference(arch, monkeypatch):
    """mnist_fc at full width (784-2048x3-10) and VGG-16 at width 0.125 in
    xnor from carried-across packed trees: the fused sites are exactly the
    ones whose next leaf takes sign words, no sign differs from the
    reference's, and the logits hold f32 tolerance."""
    if arch == "mnist_fc":
        tree, jmod, mod, n_fc = _jax_mnist(1, (2048, 2048, 2048)), jfc, mnist_fc, 4
        x = np.random.default_rng(2).uniform(0, 1, (4, 784)).astype(np.float32)
    else:
        tree, jmod, mod, n_fc = _jax_vgg(1), jvgg, vgg, 3
        x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    packed = j_compile_plan(tree["params"], j_make_paper_policy(n_fc), "xnor").pack(
        tree["params"])
    flips = record_signs(monkeypatch, jmod, mod)
    want = np.asarray(jmod.apply(packed, tree["state"], jnp.asarray(x), training=False,
                                 binary_act=True)[0])
    routes = _count_routes(monkeypatch, mod)
    params = from_jax_tree(jax.tree_util.tree_map(np.asarray, packed), device="cpu")
    state = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree["state"]), device="cpu")
    got = mod.apply(params, state, torch.from_numpy(x), binary_act=True)
    assert routes == ROUTES[arch]
    assert flips() == 0
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("mode", ["det", "xnor"])
@pytest.mark.parametrize("binary_act", [False, True])
def test_route_needs_sign_activations_and_a_leaf_that_takes_them(mode, binary_act,
                                                                 monkeypatch):
    """Packed (det) leaves and ReLU forwards keep the unfused chain."""
    from repro_torch.core.policy import make_paper_policy
    from repro_torch.engine import compile_plan

    tree = mnist_fc.init(torch.Generator().manual_seed(0), hidden=(64, 64, 64),
                         device="cpu")
    params = compile_plan(tree["params"], make_paper_policy(4), mode).pack(tree["params"])
    routes = _count_routes(monkeypatch, mnist_fc)
    out = mnist_fc.apply(params, tree["state"], torch.rand(4, 784), binary_act=binary_act)
    assert out.shape == (4, 10)
    fused = 2 if (binary_act and mode == "xnor") else 0
    assert routes == {"fused": fused, "chain": (3 - fused) if binary_act else 0}


def test_bf16_raises_and_never_takes_the_chain():
    """The fused prologue computes in f32 without the chain's two bf16
    roundings, so bf16 activations raise TypeError, on the CPU as on the
    card, and a bf16 xnor forward does not fall back to the chain."""
    case = cases.bn_inputs(4, 64, 0, "cpu")
    with pytest.raises(TypeError, match="float32"):
        bn_sign_pack(case[0].to(torch.bfloat16), *case[1:])
    tree = mnist_fc.init(torch.Generator().manual_seed(0), hidden=(64, 64), device="cpu")
    from repro_torch.core.policy import make_paper_policy
    from repro_torch.engine import compile_plan

    params = compile_plan(tree["params"], make_paper_policy(3), "xnor").pack(tree["params"])
    with pytest.raises(TypeError, match="float32"):
        mnist_fc.apply(params, tree["state"], torch.rand(4, 784, dtype=torch.bfloat16),
                       binary_act=True)


@pytest.mark.parametrize("call,err", [
    (lambda c: bn_sign_pack(c[0][0], *c[1:]), ValueError),                 # 1-D h
    (lambda c: bn_sign_pack(c[0], c[1][:-1], *c[2:]), ValueError),         # short bias
    (lambda c: bn_sign_pack(c[0], *c[1:5], c[5].double()), ValueError),    # f64 var
    (lambda c: bn_sign_pack(c[0].double(), *c[1:]), TypeError),
    (lambda c: bn_sign_pack(c[0].to("meta"), *(v.to("meta") for v in c[1:])), ValueError),
])
def test_wrapper_checks_its_inputs(call, err):
    with pytest.raises(err):
        call(cases.bn_inputs(4, 64, 0, "cpu"))
