"""Port parity for the execution plan's manifests: the six committed goldens
equal a compile as dicts and as saved file text, older manifest versions
load, overrides force, validate and raise as the reference's do, the
mesh-free sharding column and ``plan_report``/``format_plan_table`` equal
the reference's, a loaded plan packs (and routes) as a fresh compile does,
and plans packed without scales serve the reference's logits.

Logits hold f32 rtol 1e-4 / atol 1e-3, as the other port tests; scales
against the reference's f32 rtol 1e-6 (the mean |w| sums in another
order); manifests, words and reports are exact.
"""
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import DEFAULT_POLICY as J_DEFAULT_POLICY
from repro.core.policy import NONE_POLICY as J_NONE_POLICY
from repro.distributed import sharding as jsh
from repro.engine import ExecutionPlan as JExecutionPlan
from repro.engine import compile_plan as j_compile_plan
from repro.engine import format_plan_table as j_format_plan_table
from repro.engine import plan_report as j_plan_report
from repro.engine import registry as j_registry
from repro.launch.train import make_paper_policy as j_make_paper_policy
from repro.models import mnist_fc as jfc
from repro.models import vgg as jvgg
from repro_torch.configs import vgg16_cifar10 as VC
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY, NONE_POLICY, make_paper_policy
from repro_torch.distributed import sharding as sh
from repro_torch.engine import (PLAN_VERSION, ExecutionPlan, compile_plan, format_plan_table,
                                plan_report, registry)
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import mnist_fc, vgg
from repro_torch.models.layers import XnorConv, takes_sign_words

from test_torch_vgg import _jax_vgg
from test_torch_xnor import _jax_mnist

GOLDEN = Path(__file__).resolve().parents[1] / "benchmarks" / "golden_plans"
PAIRS = [(arch, mode) for arch in ("mnist_fc", "vgg16_cifar10")
         for mode in ("det", "stoch", "xnor")]
F32_TOL = dict(rtol=1e-4, atol=1e-3)
SMALL_HIDDEN = (128, 128, 128)


def _n_fc(arch):
    return 4 if arch == "mnist_fc" else 3


def _shapes(arch):
    """The full-width master tree as meta tensors: shapes, no storage."""
    gen = torch.Generator().manual_seed(0)
    if arch == "mnist_fc":
        return mnist_fc.init(gen, device="meta")["params"]
    return vgg.init(gen, width_mult=VC.WIDTH_MULT, device="meta")["params"]


def _small(arch, seed=1):
    """(reference tree, port master tree carried from it, reference model)."""
    tree = _jax_mnist(seed, SMALL_HIDDEN) if arch == "mnist_fc" else _jax_vgg(seed)
    carried = from_jax_tree(jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    return tree, carried, jfc if arch == "mnist_fc" else jvgg


def _assert_packs_equal(a_tree, b_tree):
    """Two port serving trees: the same leaf classes, words and scales."""
    a_leaves, b_leaves = list(tree_leaves_with_path(a_tree)), list(tree_leaves_with_path(b_tree))
    assert [p for p, _ in a_leaves] == [p for p, _ in b_leaves]
    for (path, a), (_, b) in zip(a_leaves, b_leaves):
        assert type(a) is type(b), path
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        else:
            assert torch.equal(a.packed, b.packed), path
            assert (a.scale is None) == (b.scale is None), path
            if a.scale is not None:
                assert torch.equal(a.scale, b.scale), path


def _assert_pack_equals_reference(port_tree, ref_tree):
    """A port serving tree against the reference's: every leaf's words bit
    for bit; scales, and binarized-dense values (+-1 x scale), within f32
    rtol 1e-6 (the mean |w| sums in another order)."""
    ref_leaves = jax.tree_util.tree_leaves_with_path(
        ref_tree, is_leaf=lambda x: hasattr(x, "packed"))
    port_leaves = list(tree_leaves_with_path(port_tree))
    assert len(ref_leaves) == len(port_leaves)
    for (_, r), (path, p) in zip(ref_leaves, port_leaves):
        if isinstance(p, torch.Tensor):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-6, atol=0,
                                       err_msg=path)
            continue
        assert type(p).__name__ == type(r).__name__, path
        np.testing.assert_array_equal(p.packed.numpy(), np.asarray(r.packed), err_msg=path)
        assert (p.scale is None) == (r.scale is None), path
        if p.scale is not None:
            np.testing.assert_allclose(p.scale.numpy(), np.asarray(r.scale), rtol=1e-6,
                                       atol=0, err_msg=path)


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", PAIRS)
def test_compiled_manifest_equals_golden_as_dict_and_text(arch, mode, tmp_path):
    golden = GOLDEN / f"{arch}_{mode}.json"
    plan = compile_plan(_shapes(arch), make_paper_policy(_n_fc(arch)), mode)
    assert plan.version == PLAN_VERSION == 3 and plan.with_scale
    assert plan.to_json() == json.loads(golden.read_text())
    saved = Path(plan.save(tmp_path / golden.name))
    assert saved.read_text() == golden.read_text()
    assert ExecutionPlan.load(saved).to_json() == plan.to_json()


@pytest.mark.parametrize("arch,mode", PAIRS)
def test_loaded_golden_packs_as_a_compile_at_full_width(arch, mode):
    tree, _, _, n_fc = serve.build_model(arch, 0, device="cpu")
    compiled = compile_plan(tree["params"], make_paper_policy(n_fc), mode)
    loaded = ExecutionPlan.load(GOLDEN / f"{arch}_{mode}.json")
    _assert_packs_equal(loaded.pack(tree["params"], key=prng.key(1)),
                        compiled.pack(tree["params"], key=prng.key(1)))


@pytest.mark.parametrize("arch,mode", PAIRS)
def test_saved_and_loaded_plan_packs_the_reference_words(arch, mode, tmp_path):
    """At a small width: the port's compile equals the reference's manifest,
    and the port's plan, saved and loaded, packs the reference's words from
    the same master weights (``interop.from_jax_tree``)."""
    tree, carried, _ = _small(arch)
    j_plan = j_compile_plan(tree["params"], j_make_paper_policy(_n_fc(arch)), mode)
    plan = compile_plan(carried["params"], make_paper_policy(_n_fc(arch)), mode)
    assert plan.to_json() == j_plan.to_json()
    loaded = ExecutionPlan.load(plan.save(tmp_path / "plan.json"))
    got = loaded.pack(carried["params"], key=prng.key(7))
    _assert_packs_equal(got, plan.pack(carried["params"], key=prng.key(7)))
    _assert_pack_equals_reference(got, j_plan.pack(tree["params"], key=jax.random.key(7)))


# ---------------------------------------------------------------------------
# manifest versions and the replica axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", [1, 2])
def test_older_manifest_versions_load(version):
    d = json.loads((GOLDEN / "mnist_fc_det.json").read_text())
    d["version"] = version
    del d["replica_axis"]
    if version == 1:
        for row in d["layers"]:
            del row["sharding"]
    plan, j_plan = ExecutionPlan.from_json(d), JExecutionPlan.from_json(d)
    assert plan.version == version and plan.replica_axis is None
    assert all((a.sharding is None) == (version == 1) for a in plan.layers)
    assert plan.to_json() == j_plan.to_json()
    tree, _, _, _ = serve.build_model("mnist_fc", 0, device="cpu")
    _assert_packs_equal(plan.pack(tree["params"]),
                        ExecutionPlan.load(GOLDEN / "mnist_fc_det.json").pack(tree["params"]))


def test_unknown_manifest_version_raises():
    d = json.loads((GOLDEN / "mnist_fc_det.json").read_text())
    d["version"] = 4
    for cls in (ExecutionPlan, JExecutionPlan):
        with pytest.raises(ValueError, match="unsupported plan version"):
            cls.from_json(d)


@pytest.mark.parametrize("axis", ["data", "model", None])
def test_replica_axis_round_trips(axis, tmp_path):
    tree, carried, _ = _small("mnist_fc")
    plan = compile_plan(carried["params"], make_paper_policy(4), "stoch", replica_axis=axis)
    j_plan = j_compile_plan(tree["params"], j_make_paper_policy(4), "stoch",
                            replica_axis=axis)
    assert plan.to_json() == j_plan.to_json()
    loaded = ExecutionPlan.load(plan.save(tmp_path / "p.json"))
    assert loaded.replica_axis == axis and loaded.version == 3
    assert loaded.sharding_axes() == j_plan.sharding_axes()
    assert [a.path for a in loaded.stochastic_rows()] == [
        a.path for a in j_plan.stochastic_rows()]
    assert [a.path for a in loaded.compute_rows()] == [a.path for a in j_plan.compute_rows()]


def test_mesh_waits_for_the_card():
    """``compile_plan(mesh=)`` sanitizes the column as the reference's does
    (a dim the mesh cannot split replicates; a mesh reading only
    ``axis_names`` and ``devices.shape`` will do), and a CUDA mesh needs a
    card: where torch sees none, building one raises."""
    class StandIn:
        axis_names = ("data", "model")
        devices = np.empty((2, 3), dtype=object)      # model axis 3

    tree = _shapes("mnist_fc")
    j_tree = jax.eval_shape(lambda: jfc.init(jax.random.key(0))["params"])
    want = j_compile_plan(j_tree, j_make_paper_policy(4), "det", mesh=StandIn())
    got = compile_plan(tree, make_paper_policy(4), "det", mesh=StandIn())
    assert got.to_json() == want.to_json()
    assert [a.sharding for a in got.layers] != [
        a.sharding for a in compile_plan(tree, make_paper_policy(4), "det").layers]
    mesh = sh.Mesh((2, 2), ("data", "model"), device="cpu")
    assert compile_plan(tree, make_paper_policy(4), "det", mesh=mesh).to_json() == \
        j_compile_plan(j_tree, j_make_paper_policy(4), "det", mesh=mesh).to_json()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            sh.Mesh((2, 2), ("data", "model"))


# ---------------------------------------------------------------------------
# overrides
# ---------------------------------------------------------------------------

def test_overrides_force_and_match_reference():
    tree, carried, _ = _small("vgg16_cifar10")
    overrides = {"conv/3": "binarized_dense", "fc/1/kernel": "packed"}
    plan = compile_plan(carried["params"], DEFAULT_POLICY, "xnor", warn=False,
                        overrides=overrides)
    j_plan = j_compile_plan(tree["params"], J_DEFAULT_POLICY, "xnor", warn=False,
                            overrides=overrides)
    assert plan.to_json() == j_plan.to_json()
    assert plan["conv/3/kernel"].backend == "binarized_dense"
    assert plan["conv/3/kernel"].reason == "override (xnor_conv -> binarized_dense)"
    assert plan["fc/1/kernel"].backend == "packed"
    assert plan["conv/4/kernel"].backend == "xnor_conv"
    packed = plan.pack(carried["params"])
    assert isinstance(packed["conv"][3]["kernel"], torch.Tensor)
    assert isinstance(packed["conv"][4]["kernel"], XnorConv)
    _assert_pack_equals_reference(packed, j_plan.pack(tree["params"]))


@pytest.mark.parametrize("mode,overrides,err,match", [
    ("xnor", {"conv/3/kernel": "xnor"}, ValueError, "override"),       # a conv leaf, FC backend
    ("det", {"conv/0/bias": "packed"}, ValueError, "ineligible"),      # policy-excluded leaf
    ("det", {"fc/1/kernel": "int5"}, KeyError, "unknown backend"),
    ("det", {"nowhere": "dense"}, ValueError, "matched no"),
    ("int5", None, ValueError, "mode"),
])
def test_overrides_and_modes_raise_as_the_reference(mode, overrides, err, match):
    tree, carried, _ = _small("vgg16_cifar10")
    with pytest.raises(err, match=match):
        compile_plan(carried["params"], DEFAULT_POLICY, mode, warn=False, overrides=overrides)
    with pytest.raises(err):
        j_compile_plan(tree["params"], J_DEFAULT_POLICY, mode, warn=False,
                       overrides=overrides)


def test_override_off_xnor_turns_the_fused_route_off(monkeypatch):
    """``layers/1/kernel`` moved to ``packed``: the layer 0 -> 1 sign site
    keeps the unfused chain (its next leaf takes no sign words), 1 -> 2
    stays fused, and the logits equal the reference's under the same
    override, from a plan that went through save and load."""
    tree, carried, _ = _small("mnist_fc")
    overrides = {"layers/1/kernel": "packed"}
    j_plan = j_compile_plan(tree["params"], j_make_paper_policy(4), "xnor",
                            overrides=overrides)
    plan = ExecutionPlan.from_json(json.loads(json.dumps(compile_plan(
        carried["params"], make_paper_policy(4), "xnor", overrides=overrides).to_json())))
    params = plan.pack(carried["params"])
    assert [takes_sign_words(lp["kernel"]) for lp in params["layers"]] == [
        False, False, True, False]
    calls = []
    orig = mnist_fc.bn_sign_words
    monkeypatch.setattr(mnist_fc, "bn_sign_words", lambda *a: calls.append(1) or orig(*a))
    x = np.random.default_rng(3).uniform(0, 1, (4, 784)).astype(np.float32)
    want = jfc.apply(j_plan.pack(tree["params"]), tree["state"], jnp.asarray(x),
                     training=False, binary_act=True)[0]
    got = mnist_fc.apply(params, carried["state"], torch.from_numpy(x), binary_act=True)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# the sharding column (mesh-free)
# ---------------------------------------------------------------------------

def _lm_like(lib):
    """A stacked transformer-like tree (the reference's LM paths) as numpy,
    so both packages compile the same leaves."""
    shapes = {"embed": (96, 64), "layers": {
        "attn": {"w_qkv": (2, 64, 192), "w_o": (2, 64, 64)},
        "mlp": {"w_up": (2, 64, 128), "w_down": (2, 128, 64)},
        "ln1": {"scale": (2, 64)}}, "lm_head": (64, 96)}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        a = np.zeros(node, np.float32)
        return jnp.asarray(a) if lib == "jax" else torch.from_numpy(a)

    return build(shapes)


@pytest.mark.parametrize("mode,policy", [("det", "default"), ("xnor", "default"),
                                         ("det", "none")])
def test_sharding_column_matches_reference(mode, policy):
    """Every row's column equals the reference's: bitpacked rows put "model"
    on the out-channel dim, xnor's row-parallel projections (w_o, w_down) on
    the contraction dim, and dense rows follow the Megatron rules."""
    pol, j_pol = ((DEFAULT_POLICY, J_DEFAULT_POLICY) if policy == "default"
                  else (NONE_POLICY, J_NONE_POLICY))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = compile_plan(_lm_like("torch"), pol, mode, warn=False)
        j_plan = j_compile_plan(_lm_like("jax"), j_pol, mode, warn=False)
    assert plan.to_json() == j_plan.to_json()
    w_o = plan["layers/attn/w_o"]
    want = {("det", "default"): [None, None, "model"], ("xnor", "default"): [None, "model", None],
            ("det", "none"): [None, "model", None]}[(mode, policy)]
    assert w_o.sharding == want
    assert plan["layers/ln1/scale"].sharding == [None, None]
    assert plan["embed"].sharding == ["model", None]


@pytest.mark.parametrize("path,ndim", [("layers/attn/w_o", 3), ("embed", 2), ("lm_head", 2),
                                       ("layers/0/bias", 1), ("conv/3/kernel", 4),
                                       ("x/router/w", 2), ("conv", 2), ("layers/0/kernel", 0)])
@pytest.mark.parametrize("fsdp", [False, True])
def test_path_rules_match_reference(path, ndim, fsdp):
    got = sh.spec_to_json(sh.leaf_pspec(path, ndim, fsdp=fsdp))
    assert got == jsh.spec_to_json(jsh.leaf_pspec(path, ndim, fsdp=fsdp))
    assert sh.spec_to_json(sh.spec_from_json(got)) == got
    for name in registry.backend_names():
        mine = sh.backend_leaf_spec(path, ndim, registry.get_backend(name))
        ref = jsh.backend_leaf_spec(path, ndim, j_registry.get_backend(name))
        assert (None if mine is None else sh.spec_to_json(mine)) == (
            None if ref is None else jsh.spec_to_json(ref)), name


def test_registry_matches_reference():
    assert registry.backend_names() == j_registry.backend_names()
    for name in registry.backend_names():
        mine, ref = registry.get_backend(name), j_registry.get_backend(name)
        assert (mine.kinds, mine.priority, mine.tp_dim, mine.tp_contract_dim) == (
            ref.kinds, ref.priority, ref.tp_dim, ref.tp_contract_dim), name
        assert mine.cost(16, 288, 64, shape=(3, 3, 32, 64), with_scale=False) == ref.cost(
            16, 288, 64, shape=(3, 3, 32, 64), with_scale=False)
    leaves = set(registry.serving_leaf_types())
    assert {t.__name__ for t in leaves} == {"PackedLinear", "XnorLinear", "XnorConv",
                                            "PackedConv"}
    for t in leaves:
        spec = registry.spec_for_serving_leaf(t.__new__(t))
        assert spec is not None and spec.leaf_type is t
    assert registry.spec_for_serving_leaf(torch.zeros(1)) is None


def test_unregister_backend_drops_its_dispatch():
    spec = registry.get_backend("packed")
    try:
        registry.unregister_backend("packed")
        assert "packed" not in registry.backend_names()
        assert registry.spec_for_serving_leaf(spec.leaf_type.__new__(spec.leaf_type)) is None
        registry.unregister_backend("packed")          # absent: no-op
    finally:
        registry.register_backend(spec)
    assert registry.backend_names() == j_registry.backend_names()


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [("vgg16_cifar10", "xnor"), ("vgg16_cifar10", "stoch"),
                                       ("mnist_fc", "det")])
@pytest.mark.parametrize("axis_sizes", [None, {"model": 4}, {"model": 1}])
def test_plan_report_and_table_match_reference(arch, mode, axis_sizes):
    tree, carried, _ = _small(arch)
    plan = compile_plan(carried["params"], DEFAULT_POLICY, mode, warn=False,
                        with_scale=mode != "stoch")
    j_plan = j_compile_plan(tree["params"], J_DEFAULT_POLICY, mode, warn=False,
                            with_scale=mode != "stoch")
    for full in (False, True):
        rows = plan_report(plan, batch=16, full=full, axis_sizes=axis_sizes)
        assert rows == j_plan_report(j_plan, batch=16, full=full, axis_sizes=axis_sizes)
        assert format_plan_table(rows) == j_format_plan_table(rows)
    assert len(plan_report(plan, full=True)) == len(plan.layers)


def test_conv_cost_counts_the_per_tap_word_layout():
    """The xnor_conv cost counts kh*kw*ceil(C/32) words (the stored layout),
    not ceil(kh*kw*C/32): they differ at the small VGG's C = 16."""
    _, carried, _ = _small("vgg16_cifar10")
    plan = compile_plan(carried["params"], DEFAULT_POLICY, "xnor", warn=False)
    row = [r for r in plan_report(plan, batch=16) if r["path"] == "conv/2/kernel"][0]
    kh, kw, c, n = row["shape"]
    assert c % 32 != 0
    words = kh * kw * ((c + 31) // 32)
    assert row["weight_bytes"] == words * n * 4 + n * 4
    assert row["costs"]["xnor_conv"] == {
        "bytes": words * n * 4 + n * 4 + 16 * words * 4 + 16 * n * 4,
        "ops": 2 * 16 * words * n}
    assert set(row["costs"]) == {"xnor_conv", "binarized_dense", "dense"}


# ---------------------------------------------------------------------------
# packing without scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [("mnist_fc", "det"), ("mnist_fc", "xnor"),
                                       ("vgg16_cifar10", "xnor"), ("vgg16_cifar10", "stoch")])
def test_unscaled_plan_serves_the_reference_logits(arch, mode):
    tree, carried, jmodel = _small(arch)
    n_fc = _n_fc(arch)
    j_plan = j_compile_plan(tree["params"], j_make_paper_policy(n_fc), mode, with_scale=False)
    plan = compile_plan(carried["params"], make_paper_policy(n_fc), mode, with_scale=False)
    assert plan.to_json() == j_plan.to_json() and not plan.with_scale
    packed = plan.pack(carried["params"], key=prng.key(7))
    j_packed = j_plan.pack(tree["params"], key=jax.random.key(7))
    _assert_pack_equals_reference(packed, j_packed)
    assert all(getattr(leaf, "scale", None) is None for _, leaf in tree_leaves_with_path(packed))
    shape = (4, 784) if arch == "mnist_fc" else (2, 32, 32, 3)
    x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    model = mnist_fc if arch == "mnist_fc" else vgg
    want = jmodel.apply(j_packed, tree["state"], jnp.asarray(x), training=False,
                        binary_act=mode == "xnor")[0]
    got = model.apply(packed, carried["state"], torch.from_numpy(x), binary_act=mode == "xnor")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# the serve's plan flags
# ---------------------------------------------------------------------------

CPU_SMOKE = ["--device", "cpu", "--smoke", "--requests", "4"]


def test_serve_saves_reports_and_serves_a_plan(tmp_path, capsys):
    out = tmp_path / "plan.json"
    first = serve.main(["--arch", "vgg16_cifar10", "--binarize", "xnor", "--plan", str(out),
                        "--plan-report", "--override", "conv/3=binarized_dense"] + CPU_SMOKE)
    text = capsys.readouterr().out
    assert "override (xnor_conv -> binarized_dense)" in text and "w-bytes dense->plan" in text
    assert ExecutionPlan.load(out).to_json() == first.plan.to_json()
    again = serve.main(["--arch", "vgg16_cifar10", "--binarize", "det", "--plan-from", str(out)]
                       + CPU_SMOKE)
    assert "was compiled with mode=xnor; serving that" in capsys.readouterr().out
    assert again.plan.mode == "xnor"
    assert torch.equal(again.last_logits, first.last_logits)


@pytest.mark.parametrize("argv,match", [
    (["--override", "conv/3"], "PATH=BACKEND"),
    (["--override", "conv/3=dense", "--plan-from", "x.json"], "cannot be combined"),
    (["--ensemble", "2"], "--binarize stoch"),
])
def test_serve_rejects_what_the_reference_rejects(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", "vgg16_cifar10"] + argv + CPU_SMOKE)


def test_serve_analyze_exits_1_on_an_error_finding(tmp_path, capsys):
    tree, _, _, _ = serve.build_model("mnist_fc", 0, device="cpu", smoke=True)
    d = compile_plan(tree["params"], make_paper_policy(3), "det").to_json()
    row = [r for r in d["layers"] if r["backend"] == "packed"][0]
    row["backend"], row["reason"] = "dense", "cannot pack: K=100 % 32 != 0"
    path = tmp_path / "broken.json"
    path.write_text(json.dumps(d))
    serve.main(["--arch", "mnist_fc", "--analyze"] + CPU_SMOKE)      # clean: no exit
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "mnist_fc", "--analyze", "--plan-from", str(path)] + CPU_SMOKE)
    assert e.value.code == 1
    assert "plan.dense_fallthrough" in capsys.readouterr().out
