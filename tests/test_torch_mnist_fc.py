"""Port parity for the whole slice: the execution plan against the committed
golden manifests, packing against the reference's words, and mnist_fc
logits from trees carried across from the reference package.
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
from repro.serve.engine import packed_param_bytes as j_packed_param_bytes
from repro_torch.core import prng
from repro_torch.core.policy import make_paper_policy
from repro_torch.data import synthetic as syn
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import mnist_fc
from repro_torch.models.layers import PackedLinear

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks" / "golden_plans"
F32_TOL = dict(rtol=1e-4, atol=1e-3)
HIDDEN = (128, 128, 128)


@pytest.mark.parametrize("mode", ["det", "stoch"])
def test_full_width_plan_matches_golden(mode):
    golden = json.loads((GOLDEN / f"mnist_fc_{mode}.json").read_text())
    tree = mnist_fc.init(torch.Generator().manual_seed(0), device="cpu")
    plan = compile_plan(tree["params"], make_paper_policy(4), mode)
    assert plan.mode == golden["mode"] and golden["with_scale"]
    assert plan.to_json() == golden          # the whole manifest, sharding column included
    assert [a.path for a in plan.assignments("packed")] == ["layers/1/kernel",
                                                            "layers/2/kernel"]


def _jax_model(seed):
    """Reference mnist_fc at HIDDEN with non-trivial bias and batch-norm
    parameters and running stats (numpy-made), so every layer matters."""
    tree = jfc.init(jax.random.key(seed), hidden=HIDDEN)
    rng = np.random.default_rng(seed)
    for lp, ls in zip(tree["params"]["layers"], tree["state"]["layers"]):
        b = lp["bias"].shape[0]
        lp["bias"] = jnp.asarray(rng.normal(0, 0.1, b).astype(np.float32))
        lp["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, b).astype(np.float32))
        lp["bn_bias"] = jnp.asarray(rng.normal(0, 0.1, b).astype(np.float32))
        ls["mean"] = jnp.asarray(rng.normal(0, 0.5, b).astype(np.float32))
        ls["var"] = jnp.asarray(rng.uniform(0.5, 4.0, b).astype(np.float32))
    return tree


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, batch=4):
    return np.random.default_rng(seed).uniform(0, 1, (batch, 784)).astype(np.float32)


@pytest.mark.parametrize("mode", ["det", "stoch"])
def test_logits_match_reference_from_carried_packed_tree(mode):
    tree = _jax_model(1)
    plan = j_compile_plan(tree["params"], j_make_paper_policy(4), mode)
    packed = plan.pack(tree["params"], key=jax.random.key(7))
    x = _images(2)
    want = np.asarray(jfc.apply(packed, tree["state"], jnp.asarray(x), training=False)[0])
    port_params = from_jax_tree(_to_numpy(packed), device="cpu")
    port_state = from_jax_tree(_to_numpy(tree["state"]), device="cpu")
    kinds = {p: type(leaf) for p, leaf in tree_leaves_with_path(port_params)}
    assert kinds["layers/1/kernel"] is PackedLinear and kinds["layers/2/kernel"] is PackedLinear
    assert kinds["layers/0/kernel"] is torch.Tensor
    got = mnist_fc.apply(port_params, port_state, torch.from_numpy(x))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert j_packed_param_bytes(packed) == serve.packed_param_bytes(port_params)


def test_det_pack_matches_reference_words_and_logits():
    tree = _jax_model(3)
    jpacked = j_compile_plan(tree["params"], j_make_paper_policy(4), "det").pack(
        tree["params"])
    master = from_jax_tree(_to_numpy(tree["params"]), device="cpu")
    plan = compile_plan(master, make_paper_policy(4), "det")
    packed = plan.pack(master)
    for i in (1, 2):
        got, want = packed["layers"][i]["kernel"], jpacked["layers"][i]["kernel"]
        assert got.k == want.k
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6)
    x = _images(4)
    want = np.asarray(jfc.apply(jpacked, tree["state"], jnp.asarray(x), training=False)[0])
    state = from_jax_tree(_to_numpy(tree["state"]), device="cpu")
    np.testing.assert_allclose(mnist_fc.apply(packed, state, torch.from_numpy(x)).numpy(),
                               want, **F32_TOL)


def test_dense_forward_matches_reference():
    tree = _jax_model(5)
    x = _images(6, batch=3)
    want = np.asarray(jfc.apply(tree["params"], tree["state"], jnp.asarray(x),
                                training=False)[0])
    port = from_jax_tree(_to_numpy(tree), device="cpu")
    got = mnist_fc.apply(port["params"], port["state"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_interop_keeps_int32_bit_patterns():
    # a stand-in named like the reference's leaf class, which interop keys on
    Leaf = type("PackedLinear", (), dict(
        packed=np.array([[-1, -(2**31), 2**31 - 1, 5]], np.int32), scale=None, k=32))

    out = from_jax_tree({"a": [Leaf()], "b": np.arange(3, dtype=np.int32)}, device="cpu")
    assert out["a"][0].packed.dtype == torch.int32 and out["a"][0].scale is None
    np.testing.assert_array_equal(out["a"][0].packed.numpy(), Leaf.packed)
    assert out["b"].dtype == torch.int32


def test_stochastic_pack_draws_from_the_generator():
    tree = mnist_fc.init(torch.Generator().manual_seed(0), hidden=(64, 64), device="cpu")
    plan = compile_plan(tree["params"], make_paper_policy(3), "stoch")

    def words(seed):
        p = plan.pack(tree["params"], key=prng.key(seed))
        return p["layers"][1]["kernel"].packed

    assert torch.equal(words(1), words(1))
    assert not torch.equal(words(1), words(2))
    with pytest.raises(ValueError, match="requires a PRNG key.*layers/1/kernel"):
        plan.pack(tree["params"])


def test_plan_pack_rejects_a_mismatched_tree():
    tree = mnist_fc.init(torch.Generator().manual_seed(0), hidden=(64, 64), device="cpu")
    plan = compile_plan(tree["params"], make_paper_policy(3), "det")
    other = mnist_fc.init(torch.Generator().manual_seed(0), hidden=(64, 96), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        plan.pack(other["params"])
    with pytest.raises(ValueError, match="mode"):
        compile_plan(tree["params"], make_paper_policy(3), "ternary")


def test_synthetic_batches_are_deterministic_images():
    spec = syn.SyntheticSpec("mnist", batch_size=4, seed=3)
    x, y = syn.train_batch(spec, 5, device="cpu")
    x2, y2 = syn.train_batch(spec, 5, device="cpu")
    assert x.shape == (4, 784) and y.shape == (4,)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert not torch.equal(x, syn.train_batch(spec, 6, device="cpu")[0])


@pytest.mark.parametrize("mode", ["det", "stoch"])
def test_serve_cli_end_to_end_on_cpu(mode, capsys):
    res = serve.main(["--device", "cpu", "--smoke", "--binarize", mode,
                      "--requests", "10", "--slots", "4"])
    out = capsys.readouterr().out
    assert f"packed weights ({mode})" in out and "img/s" in out
    assert res.requests == 10 and len(res.batch_seconds) == 3   # warm-up untimed
    assert res.warmup == serve.WARMUP_BATCHES == 1
    assert res.last_logits.shape == (4, 10) and torch.isfinite(res.last_logits).all()
    assert isinstance(res.params["layers"][1]["kernel"], PackedLinear)

