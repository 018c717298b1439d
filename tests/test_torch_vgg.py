"""Port parity for VGG-16 on CIFAR-10: plan rows against the committed golden
manifests at full width, packing against the reference's, every xnor layer
exact on a shared input, and logits from carried-across packed trees at the
smoke width (``SMOKE_WIDTH_MULT = 0.125``) in det, stoch and xnor.

Logits hold f32 rtol 1e-4 / atol 1e-3 (dense convs, batch norm and K2 sum in
another order); in xnor mode the test also counts the positions whose sign
activation differs between the two forwards (expected 0 at these seeds).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.configs import vgg16_cifar10 as JC
from repro.engine import compile_plan as j_compile_plan
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import vgg as jvgg
from repro.models.layers import apply_conv2d as j_apply_conv2d
from repro.serve.engine import packed_param_bytes as j_packed_param_bytes
from repro_torch.configs import vgg16_cifar10 as C
from repro_torch.core.policy import make_paper_policy
from repro_torch.data import synthetic as syn
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import vgg
from repro_torch.models.layers import (PackedConv, PackedLinear, XnorConv, XnorLinear,
                                       apply_conv2d, max_pool2x2)

from test_torch_xnor import record_signs

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks" / "golden_plans"
F32_TOL = dict(rtol=1e-4, atol=1e-3)
MODES = ["det", "stoch", "xnor"]


@pytest.mark.parametrize("mode", MODES)
def test_full_width_plan_matches_golden(mode):
    golden = json.loads((GOLDEN / f"vgg16_cifar10_{mode}.json").read_text())
    tree = vgg.init(torch.Generator().manual_seed(0), width_mult=C.WIDTH_MULT, device="cpu")
    plan = compile_plan(tree["params"], make_paper_policy(3), mode)
    assert plan.mode == golden["mode"] == mode and golden["with_scale"]
    assert len(plan.layers) == len(golden["layers"]) == 64
    assert plan.to_json() == golden          # the whole manifest, sharding column included


def test_structure_matches_reference():
    port = vgg.init(torch.Generator().manual_seed(0), width_mult=C.SMOKE_WIDTH_MULT,
                    device="cpu")
    ref = jvgg.init(jax.random.key(0), width_mult=JC.SMOKE_WIDTH_MULT)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), port) == shapes
    assert vgg.VGG16_CFG == jvgg.VGG16_CFG


def _jax_vgg(seed):
    """Reference VGG at the smoke width with numpy-made bias, batch-norm
    parameters and running stats, so every layer matters."""
    tree = jvgg.init(jax.random.key(seed), width_mult=JC.SMOKE_WIDTH_MULT)
    rng = np.random.default_rng(seed)
    for group in ("conv", "fc"):
        for lp, ls in zip(tree["params"][group], tree["state"][group]):
            b = lp["bias"].shape[0]
            lp["bias"] = jnp.asarray(rng.normal(0, 0.1, b).astype(np.float32))
            lp["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, b).astype(np.float32))
            lp["bn_bias"] = jnp.asarray(rng.normal(0, 0.1, b).astype(np.float32))
            ls["mean"] = jnp.asarray(rng.normal(0, 0.5, b).astype(np.float32))
            ls["var"] = jnp.asarray(rng.uniform(0.5, 4.0, b).astype(np.float32))
    return tree


def _images(seed, batch=2):
    return np.random.default_rng(seed).uniform(0, 1, (batch, 32, 32, 3)).astype(np.float32)


def _carry(tree):
    return from_jax_tree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


LEAF_KINDS = {
    "det": {"conv/1/kernel": torch.Tensor, "conv/12/kernel": torch.Tensor,
            "fc/1/kernel": PackedLinear},
    "stoch": {"conv/1/kernel": PackedConv, "conv/12/kernel": PackedConv,
              "fc/1/kernel": PackedLinear},
    "xnor": {"conv/1/kernel": torch.Tensor, "conv/2/kernel": XnorConv,
             "conv/12/kernel": XnorConv, "fc/1/kernel": XnorLinear},
}


@pytest.mark.parametrize("mode", MODES)
def test_logits_match_reference_from_carried_packed_tree(mode, monkeypatch):
    tree = _jax_vgg(1)
    packed = j_compile_plan(tree["params"], j_make_paper_policy(3), mode).pack(
        tree["params"], key=jax.random.key(7))
    x = _images(2)
    binary_act = mode == "xnor"
    flips = record_signs(monkeypatch, jvgg, vgg) if binary_act else None
    want = np.asarray(jvgg.apply(packed, tree["state"], jnp.asarray(x), training=False,
                                 binary_act=binary_act)[0])
    params, state = _carry(packed), _carry(tree["state"])
    for path, cls in LEAF_KINDS[mode].items():
        group, i, _ = path.split("/")
        assert type(params[group][int(i)]["kernel"]) is cls, path
    got = vgg.apply(params, state, torch.from_numpy(x), binary_act=binary_act)
    assert got.shape == (2, 10)
    if binary_act:
        assert flips() == 0
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert j_packed_param_bytes(packed) == serve.packed_param_bytes(params)


def test_every_xnor_conv_layer_is_exact_on_a_shared_input():
    """Layer by layer, each XnorConv gets the same input on both sides, so a
    sign flip upstream cannot hide or fake a difference."""
    tree = _jax_vgg(2)
    packed = j_compile_plan(tree["params"], j_make_paper_policy(3), "xnor").pack(
        tree["params"])
    params = _carry(packed)
    rng = np.random.default_rng(3)
    n = 0
    for jl, pl in zip(packed["conv"], params["conv"]):
        if not isinstance(pl["kernel"], XnorConv):
            continue
        x = rng.normal(size=(2, 4, 4, pl["kernel"].c_in)).astype(np.float32)
        want = np.asarray(j_apply_conv2d(jl["kernel"], jnp.asarray(x)))
        got = apply_conv2d(pl["kernel"], torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
        n += 1
    assert n == 11


@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_pack_matches_reference(mode):
    """Deterministic packing from the same master weights: binarized-dense
    values, per-tap xnor words and packed FC words all equal."""
    tree = _jax_vgg(4)
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(3), mode).pack(
        tree["params"])
    master = _carry(tree["params"])
    packed = compile_plan(master, make_paper_policy(3), mode).pack(master)
    for group in ("conv", "fc"):
        for jl, pl in zip(jpacked[group], packed[group]):
            want, got = jl["kernel"], pl["kernel"]
            if isinstance(got, torch.Tensor):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
            else:
                assert type(got).__name__ == type(want).__name__
                np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
                np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                           rtol=1e-6)


def test_max_pool_matches_reference():
    x = np.random.default_rng(5).normal(size=(2, 6, 4, 3)).astype(np.float32)
    want = np.asarray(jvgg._maxpool2x2(jnp.asarray(x)))
    np.testing.assert_array_equal(max_pool2x2(torch.from_numpy(x)).numpy(), want)


def test_cifar_batches_are_deterministic_images():
    spec = syn.SyntheticSpec("cifar", batch_size=4, seed=3)
    x, y = syn.train_batch(spec, 5, device="cpu")
    x2, y2 = syn.train_batch(spec, 5, device="cpu")
    assert x.shape == (4, 32, 32, 3) and y.shape == (4,) and x.is_contiguous()
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert not torch.equal(x, syn.train_batch(spec, 6, device="cpu")[0])


@pytest.mark.parametrize("mode", MODES)
def test_serve_cli_vgg_on_cpu(mode, capsys):
    res = serve.main(["--arch", "vgg16-cifar10", "--device", "cpu", "--smoke",
                      "--binarize", mode, "--requests", "6"])
    assert f"packed weights ({mode})" in capsys.readouterr().out
    assert res.requests == 6 and len(res.batch_seconds) == 2
    assert type(res.params["conv"][12]["kernel"]) is LEAF_KINDS[mode]["conv/12/kernel"]
    assert res.last_logits.shape == (4, 10) and torch.isfinite(res.last_logits).all()
