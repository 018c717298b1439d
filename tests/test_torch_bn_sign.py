"""The fault repair of the port's batch-norm sign sites: every input and
intermediate of the bias / eval batch norm / Eq.-1 sign chain is flushed to
zero where subnormal, as the reference's XLA CPU flushes it (DAZ and FTZ).

``xnor.cases.FLUSH_PLANTS`` plants a subnormal at each step the chain
flushes (the six inputs, x + bias, - mean, var + eps, * inv_std, * scale,
+ shift), with exact values whose unflushed chain signs the other way.
Through ``bn_sign_plain``, ``bn_sign_pack_plain`` (the plain versions of
``bn_sign`` and fused K3) and the models' xnor forwards, the port's signs
equal the reference's bit for bit. The reference runs on the CPU as its own
tests run it (Pallas kernels in interpret mode, or their plain references).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core.binarize import binarize as j_binarize
from repro.engine import compile_plan as j_compile_plan
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models import vgg as jvgg
from repro.models.layers import batch_norm as j_batch_norm
from repro_torch.core.binarize import SIGN_MIN, deterministic_binarize, flush_subnormal
from repro_torch.interop import from_jax_tree
from repro_torch.models import mnist_fc, vgg
from repro_torch.models.layers import BN_EPS, batch_norm, bn_sign
from repro_torch.xnor import cases
from repro_torch.xnor import ops as xops
from repro_torch.xnor.kernel import bn_sign as k_bn_sign
from repro_torch.xnor.kernel import bn_sign_pack_plain, bn_sign_plain, sign_pack_plain

from test_torch_xnor import record_signs


def _ref_signs(case, eps):
    """The reference's chain on the same inputs: (M, K) 0/1 sign bits."""
    h, bias, scale, shift, mean, var = (jnp.asarray(t.numpy()) for t in case)
    y = j_batch_norm(h + bias.astype(h.dtype), scale, shift, mean, var, training=False,
                     eps=eps)[0]
    return (np.asarray(j_binarize(y, "det")) > 0).astype(np.int64)


def _eager_signs(case, eps):
    """The chain without flushes (the port's before the repair)."""
    h, bias, scale, shift, mean, var = case
    y = batch_norm(h + bias, scale, shift, mean, var, eps=eps)
    return (deterministic_binarize(y) > 0).long()


def test_flush_subnormal():
    """Magnitudes below 2^-126 become a zero of their sign; 2^-126, larger
    values, +-inf and NaN pass unchanged."""
    vals, _ = cases.sign_plants(torch.float32)
    x = torch.cat([vals, torch.tensor([float("inf"), -float("inf"), 1.5, -3.0])])
    got = flush_subnormal(x)
    small = x.abs() < SIGN_MIN
    assert torch.equal(got[small], torch.zeros_like(got[small]))
    assert torch.equal(torch.signbit(got[small]), torch.signbit(x[small]))
    keep = ~small & ~x.isnan()
    assert torch.equal(got[keep], x[keep])
    assert torch.equal(got.isnan(), x.isnan())


@pytest.mark.parametrize("m", [1, 4])
def test_each_flushed_step_signs_as_the_reference(m):
    """A subnormal at each flushed step: ``bn_sign_plain`` gives the
    reference chain's signs and the planted bits, fused K3's plain version
    the same bits packed; the unflushed chain signs the other way wherever
    the flush decides (all but a subnormal result of + shift)."""
    for eps, case, bits in cases.flush_cases(m, "cpu"):
        ref = _ref_signs(case, eps)
        got = bn_sign_plain(*case, eps=eps)
        assert got.dtype == torch.float32 and got.shape == case[0].shape
        np.testing.assert_array_equal((got > 0).long().numpy(), ref)
        assert torch.equal((got > 0).long(), bits.expand(m, -1))
        np.testing.assert_array_equal(bn_sign_pack_plain(*case, eps=eps).numpy(),
                                      sign_pack_plain(torch.from_numpy(ref * 2.0 - 1).float())
                                      .numpy())
        steps = [p[0] for p in cases.FLUSH_PLANTS if p[7] == eps] * 5
        differs = (_eager_signs(case, eps) != (got > 0).long())[0]
        for step, d in zip(steps, differs.tolist()):
            assert d == (step != "+ bn_bias"), step


def test_the_flush_changes_nothing_without_subnormals():
    """On random batch-norm inputs with no subnormal anywhere, the flushed
    chain gives the eager chain's signs (the serves' logits keep theirs)."""
    case = cases.bn_inputs(64, 300, 5, "cpu", subnormals=False)
    assert torch.equal((bn_sign_plain(*case) > 0).long(), _eager_signs(case, BN_EPS))


def test_wrapper_on_cpu_is_the_plain_version():
    case = cases.plant_near_zero(cases.bn_inputs(7, 100, 3, "cpu"))
    before = k_bn_sign.launches
    got = k_bn_sign(*case)
    assert torch.equal(got, bn_sign_plain(*case))
    assert k_bn_sign.launches == before
    h = case[0]
    lead = xops.bn_sign(h.reshape(7, 1, 100), *case[1:])
    assert torch.equal(lead, got.reshape(7, 1, 100))
    assert torch.equal(bn_sign(h, *case[1:]), got)


@pytest.mark.parametrize("call,err", [
    (lambda c: k_bn_sign(c[0][0], *c[1:]), ValueError),                  # 1-D h
    (lambda c: k_bn_sign(c[0], c[1][:-1], *c[2:]), ValueError),          # short bias
    (lambda c: k_bn_sign(c[0], *c[1:5], c[5].double()), ValueError),     # f64 var
    (lambda c: k_bn_sign(c[0].to(torch.bfloat16), *c[1:]), TypeError),
    (lambda c: k_bn_sign(c[0].double(), *c[1:]), TypeError),
    (lambda c: k_bn_sign(c[0].to("meta"), *(v.to("meta") for v in c[1:])), ValueError),
])
def test_wrapper_checks_its_inputs(call, err):
    with pytest.raises(err):
        call(cases.bn_inputs(4, 64, 0, "cpu"))


# Model-level plants. With a kernel column of zeros the column's h is 0 on
# every row, so the chain's values are exact: ``_ZERO_COL`` plants the
# smallest case (- mean) and a subnormal * inv_std there. ``_ANY_H`` plants
# hold for any h with |h| << 2^10: a subnormal bn_scale behind inv_std =
# 2^20, and a subnormal product * bn_scale.
_ZERO_COL = [  # (bias, bn_scale, bn_bias, mean, var, the reference's bit)
    (2.0 ** -125, 2.0 ** 20, 0.0, 31 * 2.0 ** -130, cases.VAR_ONE, 0),
    (2.0 ** -65, 2.0 ** 20, 0.0, 0.0, 2.0 ** 126, 0),
]
_ANY_H = [
    (0.0, 2.0 ** -140, 0.0, -(2.0 ** 10), cases.VAR_2M40, 0),
    (0.0, 2.0 ** -126, 2.0 ** -126, 2.0 ** 20, 2.0 ** 60, 1),
]


def _plant(tree, kernel_group, state_group, layer, plants, zero_cols):
    """Writes ``plants`` into the first columns of one layer's bias, batch
    norm and running stats (and zeros its kernel there where ``zero_cols``);
    returns the planted column indices and bits."""
    lp, ls = tree["params"][kernel_group][layer], tree["state"][state_group][layer]
    cols, bits = [], []
    for c, (b, s, sh, mu, v, bit) in enumerate(plants):
        if zero_cols:
            lp["kernel"] = lp["kernel"].at[..., c].set(0.0)
        for d, key, val in ((lp, "bias", b), (lp, "bn_scale", s), (lp, "bn_bias", sh),
                            (ls, "mean", mu), (ls, "var", v)):
            d[key] = d[key].at[c].set(val)
        cols.append(c)
        bits.append(bit)
    return cols, bits


def _apply_both(monkeypatch, jmod, mod, params, state, x):
    """The reference's and the port's forward with binary activations on
    carried-across trees; returns (ref logits, port logits, flips, the
    reference's sign activations, the port's ``bn_sign`` outputs > 0)."""
    ref_signs, seen = [], []
    flips = record_signs(monkeypatch, jmod, mod)
    j_rec = jmod.binarize

    def j_rec_too(h, mode, *a, **k):
        out = j_rec(h, mode, *a, **k)
        ref_signs.append(np.asarray(out) > 0)
        return out

    monkeypatch.setattr(jmod, "binarize", j_rec_too)
    want = np.asarray(jmod.apply(params, state, jnp.asarray(x), training=False,
                                 binary_act=True)[0])
    orig = mod.bn_sign

    def rec(h, *vecs):
        out = orig(h, *vecs)
        seen.append(out > 0)
        return out

    monkeypatch.setattr(mod, "bn_sign", rec)
    got = mod.apply(from_jax_tree(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
                    from_jax_tree(jax.tree_util.tree_map(np.asarray, state), device="cpu"),
                    torch.from_numpy(x), binary_act=True)
    return want, got.numpy(), flips(), ref_signs, seen


@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
def test_dense_forward_with_planted_columns_signs_as_the_reference(arch, monkeypatch):
    """Master (dense) weights with binary activations: every sign site goes
    through ``bn_sign``. At the planted site the signs equal the
    reference's, the planted columns at the planted bits. mnist_fc: no sign
    anywhere differs, logits within f32 tolerance. VGG's dense convs on +-1
    inputs sum many cancelling terms in another order than the reference's,
    so later sites may flip a near-zero value; only the planted site is
    held."""
    if arch == "mnist_fc":
        tree = jfc.init(jax.random.key(3), hidden=(64, 64, 64))
        jmod, mod, group, sgroup, layer = jfc, mnist_fc, "layers", "layers", 0
        x = np.random.default_rng(4).uniform(0, 1, (4, 784)).astype(np.float32)
    else:
        tree = jvgg.init(jax.random.key(3), width_mult=0.125)
        jmod, mod, group, sgroup, layer = jvgg, vgg, "conv", "conv", 1
        x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    cols, bits = _plant(tree, group, sgroup, layer, _ZERO_COL + _ANY_H, zero_cols=True)
    want, got, flips, ref_signs, seen = _apply_both(monkeypatch, jmod, mod, tree["params"],
                                                    tree["state"], x)
    np.testing.assert_array_equal(seen[0].numpy(), ref_signs[0])
    first = seen[0].reshape(-1, seen[0].shape[-1])
    assert torch.equal(first[:, cols].long(), torch.tensor(bits).expand(first.shape[0], -1))
    if arch == "mnist_fc":
        assert flips == 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("arch", ["mnist_fc", "vgg16_cifar10"])
def test_xnor_forward_with_planted_columns_signs_as_the_reference(arch, monkeypatch):
    """The packed xnor trees (fused K3 and ``bn_sign`` sites): plants that
    hold for any h at every sign site give the reference's signs; no sign
    differs; logits within f32 tolerance."""
    if arch == "mnist_fc":
        tree = jfc.init(jax.random.key(5), hidden=(256, 256, 256))
        jmod, mod, n_fc, x = jfc, mnist_fc, 4, np.random.default_rng(6).uniform(
            0, 1, (4, 784)).astype(np.float32)
        sites = [("layers", "layers", i) for i in range(3)]
    else:
        tree = jvgg.init(jax.random.key(5), width_mult=0.125)
        jmod, mod, n_fc, x = jvgg, vgg, 3, np.random.default_rng(6).uniform(
            0, 1, (2, 32, 32, 3)).astype(np.float32)
        sites = [("conv", "conv", i) for i in range(1, 12)] + [("fc", "fc", 0), ("fc", "fc", 1)]
    for group, sgroup, layer in sites:
        _plant(tree, group, sgroup, layer, _ANY_H, zero_cols=False)
    packed = j_compile_plan(tree["params"], j_make_paper_policy(n_fc), "xnor").pack(
        tree["params"])
    want, got, flips, _, seen = _apply_both(monkeypatch, jmod, mod, packed, tree["state"], x)
    assert flips == 0 and seen
    for s in seen:
        s = s.reshape(-1, s.shape[-1])
        assert torch.equal(s[:, :2].long(), torch.tensor([0, 1]).expand(s.shape[0], -1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
