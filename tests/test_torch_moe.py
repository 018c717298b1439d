"""The port's MoE family (``models.moe``, the MoE layers of
``models.transformer``, the expert-batched K2's plain version, stacked
expert packing and ``interop``) against the reference on the CPU.

Reference master weights (``repro.models.transformer.init_lm`` at key 0)
are carried into the port with ``interop.from_jax_tree``; each side packs
them at the same key. For Moonlight's and Grok's SMOKE configs (GLU and
GELU experts), dense masters and det / stoch packed:

* the plan manifests are equal as dicts, and the (L, E, K/32, N) expert
  words equal the reference's bit for bit; a (L, E, N) scale to f32
  rounding;
* ``moe_ffn`` holds y within rtol 1e-4 / atol 1e-4 (f32), ``lb_loss`` to
  f32 rounding and ``dropped_frac`` exactly, also with experts dropped
  (``capacity_factor`` 0.05) and with a top-k tie planted at the k-th
  boundary (``jax.lax.top_k`` takes the lower expert index);
* ``forward`` (with the summed ``lb_loss``), ``prefill``, three
  ``decode_step``s and ``prefill_chunk`` hold 1e-4.

The expert-batched K2's plain version equals a loop of the 2-D one, and
with ``rows`` (the per-expert counts ``moe_ffn`` hands it) keeps each
expert's live rows and gives +0 past them; xnor-packed experts are refused
on both sides: the port names the reference's gap, whose own decode fails
on that tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.kernels import ops as jops
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.kernels import ops
from repro_torch.kernels.binary_matmul import (binary_matmul_batched,
                                               binary_matmul_batched_plain,
                                               binary_matmul_plain)
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear

MOE_ARCHS = ("moonshot_v1_16b_a3b", "grok_1_314b")
MODES = ("dense", "det", "stoch")
TOL = dict(rtol=1e-4, atol=1e-4)
PACK_SEED = 7


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _layer(tree, i):
    """Layer ``i`` of a stacked subtree on the reference's side."""
    return jax.tree.map(lambda a: a[i], tree)


class _Models:
    """Reference and port trees per (arch, mode), built once per module."""

    def __init__(self):
        self._cache = {}

    def get(self, arch, mode, **overrides):
        """(jcfg, cfg, reference tree, port tree, reference plan, port plan)."""
        key = (arch, mode, tuple(sorted(overrides.items())))
        if key not in self._cache:
            jcfg = dataclasses.replace(jcb.get_config(arch, smoke=True), **overrides)
            cfg = dataclasses.replace(cb.get_config(arch, smoke=True), **overrides)
            jp = JT.init_lm(jcfg, jax.random.key(0))
            mp = from_jax_tree(jp, device="cpu")
            jplan = plan = None
            if mode != "dense":
                jplan = j_compile_plan(jp, J_POLICY, mode)
                plan = compile_plan(mp, DEFAULT_POLICY, mode)
                jp = jplan.pack(jp, key=jax.random.key(PACK_SEED))
                mp = plan.pack(mp, key=prng.key(PACK_SEED))
            self._cache[key] = (jcfg, cfg, jp, mp, jplan, plan)
        return self._cache[key]


@pytest.fixture(scope="module")
def models():
    return _Models()


_jit_moe = jax.jit(JMOE.moe_ffn, static_argnums=0)
_jit_forward = jax.jit(JT.forward, static_argnums=0)
_jit_prefill = jax.jit(lambda cfg, p, t, max_len: JT.prefill(cfg, p, t, max_len=max_len),
                       static_argnums=(0, 3))
_jit_decode = jax.jit(JT.decode_step, static_argnums=0)


def _check_moe(jcfg, cfg, jlayer, layer, x):
    """moe_ffn on both sides: y within TOL, lb_loss to f32 rounding,
    dropped_frac equal. Returns the port's aux."""
    jy, jaux = _jit_moe(jcfg, jlayer, jnp.asarray(x))
    y, aux = MOE.moe_ffn(cfg, layer, torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_t(y), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]), rtol=1e-5)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    return aux


# ---------------------------------------------------------------------------
# the expert-batched K2 (plain version, on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [96, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_k2_equals_the_2d_loop_and_the_reference_vmap(dtype, k):
    """(E, M, K) against E packed weights, N ragged and K ragged or not,
    scaled and not: each expert equals the 2-D plain version bit for bit,
    and the reference's vmap of its op (which needs K % 32 == 0) within f32
    tolerance."""
    rng = np.random.default_rng(0)
    e, m, n = 3, 5, 70
    w = rng.normal(size=(e, k, n)).astype(np.float32)
    packed = torch.stack([ops.binarize_and_pack(torch.from_numpy(wi)) for wi in w])
    x = torch.from_numpy(rng.normal(size=(e, m, k)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, size=(e, n)).astype(np.float32))
    for s in (None, scale):
        got = binary_matmul_batched(x, packed, s)
        assert got.shape == (e, m, n) and got.dtype == torch.float32
        assert torch.equal(got, binary_matmul_batched_plain(x, packed, s))
        for i in range(e):
            assert torch.equal(got[i], binary_matmul_plain(x[i], packed[i],
                                                           None if s is None else s[i]))
        if k % 32 == 0:
            jx = jnp.asarray(x.to(torch.float32).numpy(),
                             jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
            if s is None:
                want = jax.vmap(lambda a, p: jops.binary_matmul(a, p))(jx, packed.numpy())
            else:
                want = jax.vmap(lambda a, p, sc: jops.binary_matmul(a, p, sc))(
                    jx, packed.numpy(), s.numpy())
            np.testing.assert_allclose(_t(got), _np(want), rtol=1e-5, atol=1e-4)
        # ops' wrapper: the compute-dtype rule, and a non-contiguous x
        wide = torch.zeros((e, m + 1, k), dtype=dtype)
        wide[:, :m] = x
        assert torch.equal(ops.binary_matmul_batched(wide[:, :m], packed, s), got)


def test_batched_k2_rejects_bad_operands():
    x = torch.zeros((2, 3, 64))
    w = torch.zeros((2, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        binary_matmul_batched(x, w[:1])
    with pytest.raises(ValueError, match="word rows"):
        binary_matmul_batched(x, torch.zeros((2, 3, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"scale must be float32 of shape \(2, 8\)"):
        binary_matmul_batched(x, w, torch.zeros(8))
    with pytest.raises(ValueError, match="grid.y"):
        binary_matmul_batched(torch.zeros((65536, 1, 32)),
                              torch.zeros((65536, 1, 1), dtype=torch.int32))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_k2_rows_keep_the_live_rows_and_zero_the_rest(dtype, scaled):
    """With ``rows``, expert e's first min(rows[e], M) rows equal the
    product without ``rows`` bit for bit and the rest are +0 [* scale],
    though x is nonzero there: counts 0, < M, = M and > M (clamped),
    through the wrapper and ``ops``."""
    rng = np.random.default_rng(3)
    e, m, k, n = 4, 5, 100, 70
    counts = [0, 2, m, m + 3]
    packed = torch.stack([ops.binarize_and_pack(torch.from_numpy(wi))
                          for wi in rng.normal(size=(e, k, n)).astype(np.float32)])
    x = torch.from_numpy(rng.normal(size=(e, m, k)).astype(np.float32)).to(dtype)
    s = (torch.from_numpy(rng.uniform(0.5, 1.5, size=(e, n)).astype(np.float32))
         if scaled else None)
    full = binary_matmul_batched(x, packed, s)
    rows = torch.tensor(counts)
    got = binary_matmul_batched(x, packed, s, rows)
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    for i, c in enumerate(counts):
        live = min(c, m)
        assert torch.equal(got[i, :live], full[i, :live])
        assert (got[i, live:] == 0).all() and not torch.signbit(got[i, live:]).any()
    assert torch.equal(binary_matmul_batched_plain(x, packed, s, rows), got)
    assert torch.equal(ops.binary_matmul_batched(x, packed, s, rows), got)


def test_batched_k2_rejects_bad_rows():
    x = torch.zeros((2, 3, 64))
    w = torch.zeros((2, 2, 8), dtype=torch.int32)
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros((2, 1), dtype=torch.int64)):
        with pytest.raises(ValueError, match=r"rows must have shape \(2,\)"):
            binary_matmul_batched(x, w, None, bad)
    for bad in (torch.zeros(2), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(TypeError, match="rows must be int64"):
            binary_matmul_batched(x, w, None, bad)
    with pytest.raises(ValueError, match="must share a device"):
        binary_matmul_batched(x, w, None, torch.zeros(2, dtype=torch.int64, device="meta"))


# ---------------------------------------------------------------------------
# plans, packing, interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_plans_and_expert_words_equal_the_reference(models, arch, mode):
    jcfg, cfg, jpp, pp, jplan, plan = models.get(arch, mode)
    assert plan.to_json() == jplan.to_json()
    assert plan["layers/moe/router"].backend == "dense"
    ref = dict(zip([p for p, _ in tree_leaves_with_path(pp)],
                   jax.tree_util.tree_leaves(jpp, is_leaf=lambda x: hasattr(x, "packed"))))
    n_experts = 0
    for path, leaf in tree_leaves_with_path(pp):
        r = ref[path]
        if not hasattr(r, "packed"):
            assert isinstance(leaf, torch.Tensor)
            continue
        assert type(leaf).__name__ == type(r).__name__
        np.testing.assert_array_equal(leaf.packed.numpy(), np.asarray(r.packed), err_msg=path)
        np.testing.assert_allclose(leaf.scale.numpy(), np.asarray(r.scale), rtol=1e-6,
                                   err_msg=path)
        if "/moe/" in path:
            n_experts += 1
            assert leaf.packed.shape[:2] == (cfg.n_layers, cfg.n_experts)
            assert leaf.scale.shape == (cfg.n_layers, cfg.n_experts, leaf.packed.shape[-1])
    assert n_experts == (3 if cfg.mlp_type == "glu" else 2)


def test_stoch_expert_words_come_from_split_keys(models):
    """Layer l, expert e of a stacked stochastic expert leaf equals a 2-D
    pack at ``split(fold_in(key, index), L * E)[l * E + e]``."""
    _, cfg, _, mp, _, _ = models.get("moonshot_v1_16b_a3b", "dense")
    _, _, _, pp, _, plan = models.get("moonshot_v1_16b_a3b", "stoch")
    row = plan["layers/moe/w_up"]
    e = cfg.n_experts
    keys = prng.split(prng.fold_in(prng.key(PACK_SEED), row.index), cfg.n_layers * e)
    for layer, expert in ((0, 0), (1, e - 1)):
        want = ops.binarize_and_pack(mp["layers"]["moe"]["w_up"][layer, expert],
                                     keys[layer * e + expert], stochastic=True)
        assert torch.equal(pp["layers"]["moe"]["w_up"].packed[layer, expert], want)


def test_interop_carries_the_moe_trees(models):
    jcfg, cfg, jp, mp, _, _ = models.get("grok_1_314b", "dense")
    for (path, leaf), jleaf in zip(tree_leaves_with_path(mp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf), err_msg=path)
    assert mp["layers"]["moe"]["wi"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                               cfg.d_ff)
    _, _, jpp, _, _, _ = models.get("grok_1_314b", "det")
    carried = from_jax_tree(jpp, device="cpu")["layers"]["moe"]["wo"]
    assert type(carried) is PackedLinear and carried.k == cfg.d_ff
    assert carried.master_shape == (cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)
    assert carried[1].packed.shape == (cfg.n_experts, cfg.d_ff // 32, cfg.d_model)


def test_port_init_has_the_reference_tree(models):
    for arch in MOE_ARCHS:
        _, cfg, _, mp, _, _ = models.get(arch, "dense")
        mine = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert ({p: (tuple(v.shape), v.dtype) for p, v in tree_leaves_with_path(mine)}
                == {p: (tuple(v.shape), v.dtype) for p, v in tree_leaves_with_path(mp)})


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_the_reference(models, arch, mode):
    jcfg, cfg, jp, mp, _, _ = models.get(arch, mode)
    x = np.random.default_rng(2).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    for i in range(cfg.n_layers):
        aux = _check_moe(jcfg, cfg, _layer(jp["layers"]["moe"], i),
                         T.layer_params(mp["layers"]["moe"], i), x)
        assert float(aux["dropped_frac"]) == 0.0      # SMOKE's capacity factor 8


def test_moe_ffn_hands_the_expert_k2_its_counts(models, monkeypatch):
    """A packed layer's three expert projections each get the layer's
    per-expert assignment counts as ``rows``, int64 on x's device, before
    the capacity cut (the kernel clamps them)."""
    _, cfg, _, pp, _, _ = models.get("moonshot_v1_16b_a3b", "det", capacity_factor=0.05)
    seen = []

    def spy(x, w_packed, scale=None, rows=None):
        seen.append(rows)
        return binary_matmul_batched_plain(x, w_packed, scale, rows)

    monkeypatch.setattr(ops, "_binary_matmul_batched", spy)
    layer = T.layer_params(pp["layers"]["moe"], 0)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 16, cfg.d_model))
                         .astype(np.float32))
    MOE.moe_ffn(cfg, layer, x)
    _, _, topk_e = MOE.route(cfg, layer["router"], x.reshape(64, cfg.d_model))
    want = torch.bincount(topk_e.reshape(-1), minlength=cfg.n_experts)
    assert len(seen) == 3 and want.max() > MOE.capacity(cfg, 64)
    for rows in seen:
        assert rows.dtype == torch.int64 and torch.equal(rows, want)


@pytest.mark.parametrize("mode", ["dense", "det"])
def test_moe_ffn_drops_past_capacity_as_the_reference(models, mode):
    """capacity_factor 0.05: 16 tokens x top-2 over 8 experts leave 8 rows
    an expert, so the busy experts drop assignments to the overflow row."""
    jcfg, cfg, jp, mp, _, _ = models.get("moonshot_v1_16b_a3b", mode, capacity_factor=0.05)
    assert MOE.capacity(cfg, 64) == JMOE.capacity(jcfg, 64) == 8
    x = np.random.default_rng(3).normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    aux = _check_moe(jcfg, cfg, _layer(jp["layers"]["moe"], 0),
                     T.layer_params(mp["layers"]["moe"], 0), x)
    assert 0.0 < float(aux["dropped_frac"]) < 1.0


def test_capacity_equals_the_reference():
    for arch in MOE_ARCHS:
        for smoke in (False, True):
            jcfg, cfg = jcb.get_config(arch, smoke=smoke), cb.get_config(arch, smoke=smoke)
            for t in (1, 4, 8, 32, 33, 1000, 4096):
                assert MOE.capacity(cfg, t) == JMOE.capacity(jcfg, t)


def test_planted_top_k_tie_takes_the_lower_expert(models):
    """Router columns 3 and 5 equal, column 0 twice them and the rest their
    negation, on values whose dot products are exact in f32: every token
    whose projection is positive ranks expert 0 first and ties 3 and 5 for
    the k = 2nd place. Both sides take expert 3 (so y matches the
    reference's, and differs from expert 5's)."""
    jcfg, cfg, jp, mp, _, _ = models.get("moonshot_v1_16b_a3b", "dense")
    rng = np.random.default_rng(4)
    d, e = cfg.d_model, cfg.n_experts
    v = rng.integers(-2, 3, size=(d,)).astype(np.float32) / 8
    router = np.tile(-v[:, None], (1, e))
    router[:, 0], router[:, 3], router[:, 5] = 2 * v, v, v
    x = (rng.integers(-2, 3, size=(1, 12, d)) / 4).astype(np.float32)
    x[0, :6] = np.abs(x[0, :6]) * np.sign(v)      # projection > 0: the tie is at rank 2
    jlayer = dict(_layer(jp["layers"]["moe"], 0), router=jnp.asarray(router))
    layer = dict(T.layer_params(mp["layers"]["moe"], 0), router=torch.from_numpy(router))
    _check_moe(jcfg, cfg, jlayer, layer, x)
    y, _ = MOE.moe_ffn(cfg, layer, torch.from_numpy(x))
    # swap experts 3 and 5's weights: the tied tokens now read expert 5's
    swapped = {k: (w if k == "router" else w[[0, 1, 2, 5, 4, 3, 6, 7]])
               for k, w in layer.items()}
    y5, _ = MOE.moe_ffn(cfg, swapped, torch.from_numpy(x))
    assert not torch.allclose(y[0, :6], y5[0, :6], **TOL)


# ---------------------------------------------------------------------------
# the MoE stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_stack_matches_the_reference(models, arch, mode):
    """forward (logits and the summed lb_loss), prefill, three decode
    steps, and a prompt prefilled in two chunks into slot 1."""
    jcfg, cfg, jpp, pp, _, _ = models.get(arch, mode)
    toks = _tokens(cfg, (2, 12))
    want, jaux = _jit_forward(jcfg, jpp, toks)
    got, aux = T.forward(cfg, pp, torch.from_numpy(toks))
    np.testing.assert_allclose(_t(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]), rtol=1e-5)
    assert float(aux["lb_loss"]) > 0.0

    jlg, jc = _jit_prefill(jcfg, jpp, toks, 16)
    lg, c = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(_t(lg), _np(jlg), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL)
    for step in range(3):
        tok = np.argmax(_np(jlg), axis=-1).astype(np.int32)[:, None]
        jlg, jc = _jit_decode(jcfg, jpp, jc, tok)
        lg, c = T.decode_step(cfg, pp, c, torch.from_numpy(tok))
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))

    jc, c = JT.init_cache(jcfg, 2, 16), T.init_cache(cfg, 2, 16, device="cpu")
    for off, n in ((0, 7), (7, 5)):
        jlg, jc = JT.prefill_chunk(jcfg, jpp, jc, jnp.asarray(toks[:1, off:off + n]), 1, off)
        lg, c = T.prefill_chunk(cfg, pp, c, torch.from_numpy(toks[:1, off:off + n]), 1, off)
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"offset {off}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL)
        assert c["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [0, off + n]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_xnor_experts_are_refused_on_both_sides(models, arch):
    """An xnor plan packs the experts (as the reference's does), but neither
    side can apply them: the reference's _expert_matmul takes no
    XnorLinear and its decode step fails; the port's raises naming that."""
    jcfg, cfg, jpp, pp, _, _ = models.get(arch, "xnor")
    toks = _tokens(cfg, (2, 1))
    with pytest.raises(AttributeError, match="astype"):
        JT.decode_step(jcfg, jpp, JT.init_cache(jcfg, 2, 8), jnp.asarray(toks))
    with pytest.raises(NotImplementedError, match="takes no XnorLinear"):
        T.decode_step(cfg, pp, T.init_cache(cfg, 2, 8, device="cpu"), torch.from_numpy(toks))


def test_other_families_still_raise():
    """The frontend families, once refused, are ported: internvl2's packed
    det forward from the stub's patch embeddings gives the reference's
    logits (the K2 plain version on both sides' words)."""
    from repro.models import frontends as JF
    from repro_torch.models import frontends as F

    for arch in ("internvl2_76b",):
        jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        mp = from_jax_tree(jp, device="cpu")
        jdet = j_compile_plan(jp, J_POLICY, "det").pack(jp)
        det = compile_plan(mp, DEFAULT_POLICY, "det").pack(mp)
        jx = JF.patch_embeddings(jax.random.key(6), 2, 8, jcfg.d_model)
        x = F.patch_embeddings(prng.key(6), 2, 8, cfg.d_model)
        want, _ = JT.forward(jcfg, jdet, jx)
        got, _ = T.forward(cfg, det, x)
        np.testing.assert_allclose(_t(got), _np(want), **TOL)
