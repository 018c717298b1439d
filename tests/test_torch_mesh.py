"""The port's mesh layer (``distributed.sharding``'s mesh half, ``launch.mesh``,
``compile_plan(mesh=)``, ``models.transformer.cache_pspecs`` and the
collectives of mesh serving) against the reference's own functions, on the
CPU with no process group.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so they get :class:`StandIn`, a numpy object grid
with those two attributes, and no forced JAX device count; the port gets a
CPU :class:`Mesh` of the same shape. Specs compare as tuples, words and
xnor outputs bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core.binarize import _path_str
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.distributed import sharding as JSH
from repro.engine import compile_plan as j_compile_plan
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.distributed import sharding as SH
from repro_torch.engine import ExecutionPlan, compile_plan
from repro_torch.engine import backends
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.launch import mesh as LM
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear, XnorLinear, apply_linear
from repro_torch.obs.collectives import predict_call_collectives
from repro_torch.serve import ServeEngine, packed_param_bytes
from repro_torch.xnor import ops as xops

MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4,), ("model",)), ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["2x2", "1x4", "tp4", "pod2x2x2"]
LM_ARCHS = [a for a in cb.ARCH_IDS if a not in ("mnist_fc", "vgg16_cifar10")]


class StandIn:
    """What the reference's mesh functions read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _meshes(shape, names):
    return SH.Mesh(shape, names, device="cpu"), StandIn(shape, names)


def _t(spec):
    return tuple(spec)


_TREES = {}


def _trees(arch="starcoder2_3b"):
    """(reference cfg, its masters, port cfg, the masters carried), cached."""
    if arch not in _TREES:
        jcfg = jcb.get_config(arch, smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        _TREES[arch] = (jcfg, jp, cb.get_config(arch, smoke=True),
                        from_jax_tree(jp, device="cpu"))
    return _TREES[arch]


# ---------------------------------------------------------------------------
# the rules against the reference's
# ---------------------------------------------------------------------------

SPECS = [((None, "model"), (64, 96)), (("model", None), (100, 8)),
         ((None, "model"), (64, 100)), (("data", "model"), (6, 8)),
         ((("pod", "data"), None), (8, 3)), ((None, None, "model"), (2, 64, 96)),
         (("model", "data", None), (4, 4)), (("x", "model"), (4, 8)),
         ((None, "model", None), (3, 16)), (("model",), ())]


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_sanitize_spec_equals_the_reference(shape, names):
    mesh, stand = _meshes(shape, names)
    for spec, arr in SPECS:
        want = _t(JSH.sanitize_spec(stand, JSH.P(*spec), arr))
        assert SH.sanitize_spec(mesh, spec, arr) == want, (spec, arr)
        assert SH.sanitize_spec(stand, spec, arr) == want
    for spec, nd in [((None, "model"), 1), (("model", None, None), 2), ((None, "model"), 4)]:
        assert SH._adapt_spec(spec, nd) == _t(JSH._adapt_spec(JSH.P(*spec), nd))


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_compile_plan_sharding_column_equals_the_reference(shape, names, mode):
    """``compile_plan(..., mesh=)`` sanitizes every row's column as the
    reference's does; a replica axis the mesh lacks raises on both sides."""
    mesh, stand = _meshes(shape, names)
    for arch in ("starcoder2_3b", "qwen2_5_32b"):
        _, jp, _, mp = _trees(arch)
        want = j_compile_plan(jp, J_POLICY, mode, warn=False, mesh=stand).to_json()
        assert compile_plan(mp, DEFAULT_POLICY, mode, warn=False, mesh=mesh).to_json() == want
    if "data" not in names:
        for fn, tree, pol in ((compile_plan, mp, DEFAULT_POLICY), (j_compile_plan, jp, J_POLICY)):
            with pytest.raises(ValueError, match="replica_axis"):
                fn(tree, pol, "stoch", warn=False, mesh=stand, replica_axis="data")


def _want_placement(stand, jtree, jplan):
    """path -> the spec each stored array gets from the reference's
    ``place_packed_params`` rules: the row's column (or
    ``serving_leaf_pspec`` without a plan) sanitized on the master shape,
    then adapted to and sanitized on the words (a tensor: its own shape)."""
    types = JSH._serving_leaf_types()
    rows = {a.path: a.pspec for a in jplan.layers} if jplan is not None else {}
    out = {}
    for path, node in jax.tree_util.tree_leaves_with_path(
            jtree, is_leaf=lambda x: isinstance(x, types)):
        s = _path_str(path)
        spec = rows.get(s)
        if spec is None:
            spec = JSH.serving_leaf_pspec(s, node)
        master = getattr(node, "master_shape", getattr(node, "shape", ()))
        spec = JSH.sanitize_spec(stand, spec, master)
        arr = node.packed if isinstance(node, types) else node
        out[s] = _t(JSH.sanitize_spec(stand, JSH._adapt_spec(spec, arr.ndim), arr.shape))
    return out


@pytest.mark.parametrize("mode,with_plan", [("det", True), ("det", False), ("xnor", True),
                                             ("xnor", False), ("dense", False)],
                         ids=["det-plan", "det-no-plan", "xnor-plan", "xnor-no-plan", "dense"])
@pytest.mark.parametrize("shape,names", MESHES[:3], ids=MESH_IDS[:3])
def test_place_packed_params_equals_the_reference(shape, names, mode, with_plan):
    """Every placed leaf's spec is the reference's; every position holds its
    own shard, whose words are the unplaced words' slice (a lane group is
    never split: the word dim shards only in whole words), and a
    row-parallel shard's ``k`` counts its range's bits."""
    mesh, stand = _meshes(shape, names)
    _, jp, cfg, mp = _trees()
    if mode == "dense":     # a dense tree has no plan: placed by the path rules
        jtree, tree, jplan, plan = jp, mp, None, None
    else:
        jplan = j_compile_plan(jp, J_POLICY, mode, warn=False, mesh=stand)
        plan = compile_plan(mp, DEFAULT_POLICY, mode, warn=False, mesh=mesh)
        jtree, tree = jplan.pack(jp), plan.pack(mp)
        if not with_plan:
            jplan = plan = None
    want = _want_placement(stand, jtree, jplan)
    placed = SH.place_packed_params(mesh, tree, plan)
    assert packed_param_bytes(placed) == packed_param_bytes(tree)
    n_model = mesh.model_size
    for (path, leaf), (_, orig) in zip(tree_leaves_with_path(placed),
                                       tree_leaves_with_path(tree)):
        assert leaf.spec == want[path], path
        words = orig.packed if hasattr(orig, "packed") else orig
        dim = leaf.model_dim()
        held = [leaf.local.flat[p] for p in range(mesh.size)]
        assert len({id(q.packed if hasattr(q, "packed") else q) for q in held}) == mesh.size
        for row in mesh.groups():
            parts = [leaf.local.flat[p] for p in row]
            got = [q.packed if hasattr(q, "packed") else q for q in parts]
            if dim is None:
                for q in got:
                    assert torch.equal(q, words), path
            else:
                assert torch.equal(torch.cat(got, dim=dim), words), path
                if dim == -2 and hasattr(orig, "k"):
                    assert sum(q.k for q in parts) == orig.k
                    assert all(q.k == q.packed.shape[-2] * 32 for q in parts)
                    assert got[0].shape[-2] == words.shape[-2] // n_model


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_divisibility_report_equals_the_reference(arch):
    for n in (2, 4, 16):
        assert SH.divisibility_report(cb.get_config(arch), n) == JSH.divisibility_report(
            jcb.get_config(arch), n)


@pytest.mark.parametrize("arch", [a for a in cb.ARCH_IDS if a not in ("mnist_fc", "vgg16_cifar10")])
def test_tp16_divisibility(arch):
    """The documented invariant: d_ff / q_dim / kv_dim / d_inner shard over
    a 16-way model axis for every assigned arch."""
    cfg = cb.get_config(arch)
    rep = SH.divisibility_report(cfg, 16)
    assert rep["d_ff"] and rep["q_dim"] and rep["kv_dim"] and rep["d_inner"], (arch, rep)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_130m", "jamba_1_5_large"])
def test_cache_pspecs_equal_the_reference(arch):
    cfg, jcfg = cb.get_config(arch, smoke=True), jcb.get_config(arch, smoke=True)
    for dp in (("data",), ("pod", "data"), ()):
        want = {k: _t(v) for k, v in JT.cache_pspecs(jcfg, dp).items()}
        assert T.cache_pspecs(cfg, dp) == want, dp


def test_cache_pspecs_handle_empty_data_axes():
    """A pure tensor-parallel mesh has no data or pod axis: slot dims
    replicate (entry None)."""
    for arch in ("starcoder2_3b", "mamba2_130m", "jamba_1_5_large"):
        cfg = cb.get_config(arch, smoke=True)
        specs = T.cache_pspecs(cfg, dp_axes=())
        assert set(specs) == set(T.cache_slot_axes(cfg))
        for name, axis in T.cache_slot_axes(cfg).items():
            assert len(specs[name]) <= axis + 1 or specs[name][axis] is None, (arch, name)
        assert specs["pos"] == (None,)


@pytest.mark.parametrize("fsdp", [False, True])
def test_params_pspecs_equal_the_reference(fsdp):
    jcfg = jcb.get_config("jamba_1_5_large", smoke=True)
    jp = jax.eval_shape(lambda: JT.init_lm(jcfg, jax.random.key(0)))
    want = [_t(s) for s in jax.tree_util.tree_leaves(
        JSH.params_pspecs(jp, fsdp=fsdp), is_leaf=lambda x: isinstance(x, JSH.P))]
    shapes = T.lm_shapes(cb.get_config("jamba_1_5_large", smoke=True))
    specs = SH.params_pspecs(shapes, fsdp=fsdp)
    got = []
    for path, _ in tree_leaves_with_path(shapes):     # a spec tuple is no subtree
        node = specs
        for key in path.split("/"):
            node = node[key]
        got.append(node)
    assert got == want


def test_plan_manifest_roundtrips_sharding_column(tmp_path):
    """The sharding column survives save/load, and the loaded plan packs as
    the compiled one; binary backends put "model" on the out-channel dim,
    the embedding is vocab-parallel, norms replicate."""
    _, _, cfg, mp = _trees()
    plan = compile_plan(mp, DEFAULT_POLICY, "det", warn=False)
    loaded = ExecutionPlan.load(plan.save(tmp_path / "plan.json"))
    assert loaded.to_json() == plan.to_json()
    row = loaded["layers/attn/w_qkv"]
    assert row.backend == "packed" and row.sharding == [None, None, "model"]
    assert row.pspec == (None, None, "model")
    assert loaded["embed/embedding"].sharding == ["model", None]
    assert loaded["layers/ln1/scale"].sharding == [None, None]
    for (_, a), (_, b) in zip(tree_leaves_with_path(loaded.pack(mp)),
                              tree_leaves_with_path(plan.pack(mp))):
        assert torch.equal(a.packed if hasattr(a, "packed") else a,
                           b.packed if hasattr(b, "packed") else b)


# ---------------------------------------------------------------------------
# the mesh, the row-parallel partials and the collective counters
# ---------------------------------------------------------------------------

def test_meshes_and_the_device_rule():
    m = LM.make_debug_mesh(device="cpu")
    assert m.shape == (2, 4) and m.axis_names == ("data", "model") and LM.chips(m) == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.groups().tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    big = LM.make_production_mesh(multi_pod=True, device="cpu")
    assert big.shape == (2, 16, 16) and big.axis_names == ("pod", "data", "model")
    assert big.groups().shape == (32, 16)
    assert LM.chips(LM.make_production_mesh(device="cpu")) == 256
    assert SH.batch_axes(big) == ("pod", "data") and SH.batch_axes(None) == ("data",)
    assert SH.batch_axes(SH.Mesh((4,), ("model",), device="cpu")) == ()
    with pytest.raises(ValueError, match="axes"):
        SH.Mesh((2, 2), ("data",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            SH.Mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("scaled", [True, False])
def test_xnor_row_partials_sum_then_scale_equal_unsharded_k4(n_model, scaled):
    """A row-parallel xnor projection: each range's unscaled int32 K3 + K4
    partial, summed, then scaled once, equals the unsharded K4 bit for bit
    (K4 with the scale in its flush would scale each partial)."""
    g = torch.Generator().manual_seed(3)
    k, n = 512, 96
    x = torch.randn(5, 3, k, generator=g)
    w = torch.randn(k, n, generator=g)
    from repro_torch.kernels import ops
    words = ops.binarize_and_pack(w)
    scale = w.abs().mean(0) if scaled else None
    want = xops.xnor_matmul(x, words, scale, k=k, out_dtype=torch.float32)
    leaf = XnorLinear(words, scale, k)
    mesh = SH.Mesh((1, n_model), ("data", "model"), device="cpu")
    view = SH.group_view(SH.place_packed_params(mesh, {"w_o": leaf}), 0)["w_o"]
    assert isinstance(view, SH.ModelShards) and view.dim == -2
    before = SH.collective_counts()
    got = apply_linear(view, x)
    assert SH.collective_counts()["all-reduce"] == before["all-reduce"] + 1
    assert torch.equal(got, want)
    partials = [backends.row_partial(p, x[..., i * k // n_model:(i + 1) * k // n_model])
                for i, p in enumerate(view.parts)]
    assert all(q.dtype == torch.int32 for q in partials)
    assert torch.equal(sum(partials), xops.xnor_matmul(x, words, None, k=k))


@pytest.mark.parametrize("mode", ["det", "xnor"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_collective_counters_equal_the_plan_prediction(shape, mode):
    """One decode step's all-gather / all-reduce counts equal the plan's
    ``predict_row_collective`` summed over its rows at the mesh's axis
    sizes, once per data group; a slot's prefill and a prefill chunk run
    on one group."""
    mesh = SH.Mesh(shape, ("data", "model"), device="cpu")
    _, _, cfg, mp = _trees()
    plan = compile_plan(mp, DEFAULT_POLICY, mode, warn=False, mesh=mesh)
    eng = ServeEngine(cfg, plan.pack(mp), mesh=mesh, plan=plan)
    state = eng.init_decode(4, 8, 4)
    groups = len(state.cache.parts)
    assert groups == shape[0]
    rng = np.random.default_rng(0)

    def counted(fn):
        SH.reset_collective_counts()
        out = fn()
        return out, SH.collective_counts()

    state, c = counted(lambda: eng.prefill_into(state, 0, rng.integers(0, cfg.vocab_size, 8)))
    assert c == predict_call_collectives(plan, mesh.axis_sizes(), groups=1)
    state, c = counted(lambda: eng.decode_step(state, np.zeros(4, np.int32)))
    want = predict_call_collectives(plan, mesh.axis_sizes(), groups=groups)
    assert c == want
    per_group = {"det": {"all-gather": 4 * cfg.n_layers + 1, "all-reduce": 1},
                 "xnor": {"all-gather": 2 * cfg.n_layers + 1,
                          "all-reduce": 2 * cfg.n_layers + 1}}[mode]
    assert want == {k: v * groups for k, v in per_group.items()}
    _, c = counted(lambda: eng.prefill_chunk_into(state, 1, np.arange(3), 0))
    assert c == predict_call_collectives(plan, mesh.axis_sizes(), groups=1)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_xnor_projections_on_the_mesh_equal_single_device_bit_for_bit(shape):
    """Every xnor projection of a decode step (column shards gathered, row
    shards' int32 partials summed, then scaled) equals the single-device
    K3 + K4 output bit for bit, on the same inputs."""
    mesh = SH.Mesh(shape, ("data", "model"), device="cpu")
    _, _, cfg, mp = _trees()
    plan = compile_plan(mp, DEFAULT_POLICY, "xnor", warn=False, mesh=mesh)
    tree = plan.pack(mp)
    view = SH.group_view(SH.place_packed_params(mesh, tree, plan), 0)
    x = torch.randn(4, 1, 512, generator=torch.Generator().manual_seed(0))
    n = 0
    for path, leaf in tree_leaves_with_path(tree):
        if not isinstance(leaf, XnorLinear):
            continue
        sharded = view
        for key in path.split("/"):
            sharded = sharded[key]
        for i in range(cfg.n_layers):
            xi = x[..., :leaf.k]
            assert torch.equal(apply_linear(sharded[i], xi), apply_linear(leaf[i], xi)), path
            n += 1
    assert n == 4 * cfg.n_layers
    assert isinstance(view["layers"]["attn"]["w_qkv"], SH.ModelShards)
    assert isinstance(view["layers"]["attn"]["w_qkv"].parts[0], XnorLinear)
    assert not isinstance(view["layers"]["ln1"]["scale"], SH.ModelShards)
    assert not any(isinstance(p, PackedLinear) for p in view["layers"]["mlp"]["wo"].parts)
