"""The port's hybrid template (the ``hybrid`` branches of
``models.transformer``: periods of Mamba2 mixers around one attention layer,
MoE on alternate layers; jamba-1.5-large's SMOKE config, 8 layers in 2
periods of 4, 4 experts), its plans and words, and the draw-and-pack route
(``ExecutionPlan.pack_drawn``), against the reference on the CPU.

Model parity carries the reference's master weights (``init_lm`` at key 0)
into the port with ``interop.from_jax_tree``, and each side packs them at
the same key; inputs are drawn with numpy from fixed seeds. Tolerances are
the ones the port's other f32 parity tests take from the reference's rows
(``tests/test_models.py``, ``tests/test_serving.py``):

* ``forward`` (logits and the summed ``lb_loss``), ``prefill``,
  ``decode_step`` and ``prefill_chunk`` (at offset 0 over a stale occupant,
  and past it) in dense / det / stoch: ``TOL`` (1e-4; the SMOKE config is
  f32, and the port sums the SSD, the router and the norms in f64);
* decode against forward within the port: rtol 5e-2 / atol 5e-3;
* the plans equal the reference's as dicts in det, stoch and xnor (the
  doubly stacked leaves' sharding columns included), and every packed
  leaf's words, stochastic ones too, bit for bit;
* the plan compiled from the masters' shapes equals the one compiled from
  the masters, and the draw-and-pack route equals ``plan.pack(init_lm(...))``
  leaf for leaf, bit for bit.
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
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear, XnorLinear, lm_init

ARCH = "jamba_1_5_large"
MODES = ("dense", "det", "stoch")
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=5e-2, atol=5e-3)        # decode against forward
PACK_SEED = 7
# the projections the plan packs
PACKED = {"layers/attn/w_qkv", "layers/attn/w_o", "layers/mamba/in_proj",
          "layers/mamba/out_proj", "layers/mlp/w_gate", "layers/mlp/w_up",
          "layers/mlp/w_down", "layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down"}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


class _Models:
    """Reference and port trees per mode, built once per module."""

    def __init__(self):
        self._cache = {}

    def get(self, mode):
        """(jcfg, cfg, reference tree, port tree, reference plan, port plan)."""
        if mode not in self._cache:
            jcfg, cfg = jcb.get_config(ARCH, smoke=True), cb.get_config(ARCH, smoke=True)
            jp = JT.init_lm(jcfg, jax.random.key(0))
            mp = from_jax_tree(jp, device="cpu")
            jplan = plan = None
            if mode != "dense":
                jplan = j_compile_plan(jp, J_POLICY, mode)
                plan = compile_plan(mp, DEFAULT_POLICY, mode)
                jp = jplan.pack(jp, key=jax.random.key(PACK_SEED))
                mp = plan.pack(mp, key=prng.key(PACK_SEED))
            self._cache[mode] = (jcfg, cfg, jp, mp, jplan, plan)
        return self._cache[mode]


@pytest.fixture(scope="module")
def models():
    return _Models()


_jit_forward = jax.jit(JT.forward, static_argnums=0)
_jit_prefill = jax.jit(lambda cfg, p, t, max_len: JT.prefill(cfg, p, t, max_len=max_len),
                       static_argnums=(0, 3))
_jit_decode = jax.jit(JT.decode_step, static_argnums=0)


# ---------------------------------------------------------------------------
# init, draw order, plans, words
# ---------------------------------------------------------------------------

def test_port_init_has_the_reference_tree(models):
    _, cfg, jp, _, _, _ = models.get("dense")
    mine = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(v.shape) for p, v in tree_leaves_with_path(mine)} == {
        p: tuple(v.shape) for p, v in tree_leaves_with_path(from_jax_tree(jp, device="cpu"))}
    mamba = mine["layers"]["mamba"]
    assert mamba["in_proj"].shape == (2, 3, cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state
                                      + cfg.ssm_heads)
    assert mine["layers"]["moe"]["w_down"].shape == (2, 2, cfg.n_experts, cfg.d_ff, cfg.d_model)
    np.testing.assert_allclose(_t(mamba["A_log"]), _np(jp["layers"]["mamba"]["A_log"]),
                               rtol=1e-6)
    assert torch.equal(mamba["D"], torch.ones_like(mamba["D"]))
    assert not mine["layers"]["ln1"]["scale"].any() and not mamba["dt_bias"].any()


def test_init_lm_draws_each_matrix_in_the_documented_order():
    """``init_lm`` replays as ``lm_draws`` says: leaf by leaf, a stacked
    projection one ``lm_init`` (K, N) draw a matrix, row-major over its
    leading dims, the whole leaves one call each."""
    cfg = cb.get_config(ARCH, smoke=True)
    mine = dict(tree_leaves_with_path(T.init_lm(cfg, torch.Generator().manual_seed(4),
                                                device="cpu")))
    draws = T.lm_draws(cfg)
    assert sorted(d.path for d in draws) == sorted(mine)
    assert [d.path for d in draws if d.fan_in is not None] == [
        "layers/attn/w_qkv", "layers/attn/w_o", "layers/mamba/in_proj",
        "layers/mamba/out_proj", "layers/mlp/w_gate", "layers/mlp/w_up", "layers/mlp/w_down",
        "layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down"]
    g = torch.Generator().manual_seed(4)
    for d in draws:
        leaf = mine[d.path]
        if d.fan_in is None:
            assert torch.equal(d.whole(g, "cpu"), leaf), d.path
            continue
        flat = leaf.reshape(-1, *leaf.shape[-2:])
        for i in range(flat.shape[0]):
            w = lm_init(g, tuple(leaf.shape[-2:]), fan_in=d.fan_in, device="cpu")
            assert torch.equal(w, flat[i]), (d.path, i)
    # the experts of one MoE layer are separate draws
    gate = mine["layers/moe/w_gate"]
    assert not torch.equal(gate[0, 0, 0], gate[0, 0, 1])


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_plans_and_words_equal_the_reference(mode):
    """The plans as dicts (the doubly stacked leaves' sharding columns
    included), and every packed leaf's words and scales bit for bit, the
    stochastic words of the (n_per, 4, E, K, N) expert leaves too."""
    jcfg = jcb.get_config(ARCH, smoke=True)
    jp = JT.init_lm(jcfg, jax.random.key(0))
    mp = from_jax_tree(jp, device="cpu")
    jplan, plan = j_compile_plan(jp, J_POLICY, mode), compile_plan(mp, DEFAULT_POLICY, mode)
    assert plan.to_json() == jplan.to_json()
    want = "xnor" if mode == "xnor" else "packed"
    assert {r.path for r in plan.assignments(want)} == PACKED
    assert plan["layers/moe/w_gate"].sharding == [None, None, None, None, "model"]
    assert plan["layers/mamba/conv"].sharding == [None, None, None, "model"]
    jpp = jplan.pack(jp, key=jax.random.key(PACK_SEED))
    pp = plan.pack(mp, key=prng.key(PACK_SEED))
    ref = dict(zip([p for p, _ in tree_leaves_with_path(pp)],
                   jax.tree_util.tree_leaves(jpp, is_leaf=lambda x: hasattr(x, "packed"))))
    for path, leaf in tree_leaves_with_path(pp):
        r = ref[path]
        if path not in PACKED:
            assert isinstance(leaf, torch.Tensor), path
            continue
        assert type(leaf) is (XnorLinear if mode == "xnor" else PackedLinear)
        assert type(leaf).__name__ == type(r).__name__
        np.testing.assert_array_equal(leaf.packed.numpy(), np.asarray(r.packed), err_msg=path)
        np.testing.assert_allclose(leaf.scale.numpy(), np.asarray(r.scale), rtol=1e-6)
        assert leaf.master_shape == tuple(r.master_shape)


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_draw_and_pack_equals_pack_of_init_lm(mode):
    """The plan compiled from the masters' shapes (``lm_shapes``, on the
    meta device) equals the one compiled from the masters, and
    ``pack_drawn`` (in det and stoch each matrix packed as it is drawn; xnor
    has no matrix packer, so its leaves are drawn whole) gives
    ``plan.pack(init_lm(...))`` leaf for leaf, bit for bit, with 2 periods."""
    cfg = cb.get_config(ARCH, smoke=True)
    masters = T.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    plan = compile_plan(masters, DEFAULT_POLICY, mode)
    shapes = T.lm_shapes(cfg)
    assert all(leaf.device.type == "meta" for _, leaf in tree_leaves_with_path(shapes))
    assert compile_plan(shapes, DEFAULT_POLICY, mode).to_json() == plan.to_json()
    want = plan.pack(masters, key=prng.key(5))
    got = plan.pack_drawn(T.lm_draws(cfg), torch.Generator().manual_seed(3), key=prng.key(5),
                          device="cpu")
    want_l, got_l = list(tree_leaves_with_path(want)), list(tree_leaves_with_path(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, w), (_, g) in zip(want_l, got_l):
        assert type(g) is type(w), path
        if path in PACKED:
            assert g.packed.shape[0] == 2                  # n_per
            assert torch.equal(g.packed, w.packed) and torch.equal(g.scale, w.scale), path
            assert g.k == w.k
        else:
            assert torch.equal(g, w), path


def test_draw_and_pack_checks_the_plan():
    cfg = cb.get_config(ARCH, smoke=True)
    plan = compile_plan(T.lm_shapes(cfg), DEFAULT_POLICY, "det")
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="plan/draws mismatch"):
        plan.pack_drawn(T.lm_draws(cfg)[:-1], g, device="cpu")
    wide = dataclasses.replace(cfg, n_layers=12)
    with pytest.raises(ValueError, match="shape mismatch"):
        plan.pack_drawn(T.lm_draws(wide), g, device="cpu")
    with pytest.raises(ValueError, match="draws its stacked leaves whole"):
        T.lm_draws(cb.get_config("mamba2_130m", smoke=True))


def test_depth_must_be_a_multiple_of_the_period():
    """The reference's ``n_layers // attn_period`` would drop the rest of
    the layers without a word; the port refuses such a depth."""
    cfg = cb.get_config(ARCH, smoke=True)
    bad = dataclasses.replace(cfg, n_layers=6)
    with pytest.raises(ValueError, match="not a positive multiple"):
        T.init_lm(bad, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="not a positive multiple"):
        serve.serve_lm(arch=ARCH, smoke=True, n_layers=6, packed=True, device="cpu")
    with pytest.raises(ValueError, match="not a positive multiple"):
        serve.serve_lm(arch=ARCH, smoke=True, n_layers=0, device="cpu")


@pytest.mark.parametrize("arch", ["musicgen_large", "internvl2_76b"])
def test_frontend_families_still_raise(arch):
    """The frontend families, once refused, are ported: a forward from the
    stub's embeddings (B, S, D) in place of tokens gives the reference's
    logits."""
    from repro.models import frontends as JF
    from repro_torch.models import frontends as F

    jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
    jp = JT.init_lm(jcfg, jax.random.key(0))
    jx = JF.STUBS[jcfg.frontend](jax.random.key(4), 2, 10, jcfg.d_model)
    x = F.STUBS[cfg.frontend](prng.key(4), 2, 10, cfg.d_model)
    want, _ = JT.forward(jcfg, jp, jx)
    got, _ = T.forward(cfg, from_jax_tree(jp, device="cpu"), x)
    np.testing.assert_allclose(_t(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_the_reference(models, mode):
    jcfg, cfg, jpp, pp, _, _ = models.get(mode)
    toks = _tokens(cfg, (2, 16))
    want, jaux = _jit_forward(jcfg, jpp, toks)
    got, aux = T.forward(cfg, pp, torch.from_numpy(toks))
    assert got.shape == (2, 16, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_t(got), _np(want), **TOL)
    # the 4 MoE layers' load-balance losses, summed in layer order
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]), rtol=1e-5)
    assert float(aux["lb_loss"]) > 0


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_the_reference(models, mode):
    """Prefill's logits and every cache entry, then 3 decode steps: K/V
    written in place, ``ssm``/``conv`` returned anew (the old tensors left
    as they were)."""
    jcfg, cfg, jpp, pp, _, _ = models.get(mode)
    toks = _tokens(cfg, (2, 12))
    jlg, jc = _jit_prefill(jcfg, jpp, toks, 16)
    lg, c = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(_t(lg), _np(jlg), **TOL)
    assert set(c) == set(jc) == {"pos", "k", "v", "ssm", "conv"}
    for name in ("k", "v", "ssm", "conv"):
        assert c[name].shape == jc[name].shape, name
        np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL, err_msg=name)
    for step in range(3):
        tok = np.argmax(_np(jlg), axis=-1).astype(np.int32)[:, None]
        jlg, jc = _jit_decode(jcfg, jpp, jc, tok)
        ssm_before, ssm_old = c["ssm"], c["ssm"].clone()
        k_before = c["k"]
        lg, c = T.decode_step(cfg, pp, c, torch.from_numpy(tok))
        assert torch.equal(ssm_before, ssm_old) and c["ssm"] is not ssm_before
        assert c["k"] is k_before                      # written in place
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v", "ssm", "conv"):
        np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL, err_msg=name)


def test_decode_matches_forward(models):
    """The reference's prefill/decode consistency row, within the port:
    prefill 12 tokens, then decode 9 more against the full forward."""
    _, cfg, _, mp, _, _ = models.get("dense")
    toks = torch.from_numpy(_tokens(cfg, (1, 21), seed=2))
    logits, _ = T.forward(cfg, mp, toks)
    lp, cache = T.prefill(cfg, mp, toks[:, :12], max_len=21)
    np.testing.assert_allclose(_t(lp), _t(logits[:, 11]), **DECODE_TOL)
    for t in range(12, 21):
        ld, cache = T.decode_step(cfg, mp, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(_t(ld), _t(logits[:, t]), **DECODE_TOL, err_msg=f"{t}")


@pytest.mark.parametrize("mode", ["dense", "det"])
def test_prefill_chunk_matches_the_reference(models, mode):
    """Slot 1 of 2 prefilled in chunks of 5, 5 and 2 (offset 0 over a stale
    occupant, then past it; the last chunk shorter than the conv width): the
    logits and every cache entry of each chunk equal the reference's, the
    whole-prompt prefill's within ``TOL``; slot 0 is untouched."""
    jcfg, cfg, jpp, pp, _, _ = models.get(mode)
    toks = _tokens(cfg, (1, 12), seed=5)
    rng = np.random.default_rng(7)
    c = T.init_cache(cfg, 2, 16, device="cpu")
    stale = rng.normal(size=tuple(c["ssm"].shape)).astype(np.float32)
    stale_conv = rng.normal(size=tuple(c["conv"].shape)).astype(np.float32)
    jc = dict(JT.init_cache(jcfg, 2, 16), ssm=jnp.asarray(stale), conv=jnp.asarray(stale_conv))
    c["ssm"].copy_(torch.from_numpy(stale))
    c["conv"].copy_(torch.from_numpy(stale_conv))
    slot0 = {name: c[name][:, :, 0].clone() for name in ("ssm", "conv")}
    off = 0
    for n in (5, 5, 2):
        chunk = toks[:, off:off + n]
        jlg, jc = JT.prefill_chunk(jcfg, jpp, jc, jnp.asarray(chunk), 1, off)
        lg, c = T.prefill_chunk(cfg, pp, c, torch.from_numpy(chunk), 1, off)
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"{off}")
        for name in ("k", "v", "ssm", "conv"):
            np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL,
                                       err_msg=f"{name} at {off}")
        assert c["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        off += n
    for name in ("ssm", "conv"):
        assert torch.equal(c[name][:, :, 0], slot0[name]), name
    wlg, wc = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(_t(lg), _t(wlg), **TOL)
    np.testing.assert_allclose(_t(c["ssm"][:, :, 1:2]), _t(wc["ssm"]), **TOL)
    np.testing.assert_allclose(_t(c["conv"][:, :, 1:2]), _t(wc["conv"]), **TOL)
    np.testing.assert_allclose(_t(c["k"][:, 1:2, :12]), _t(wc["k"][:, :, :12]), **TOL)


def test_cache_layout_and_slot_ops(models):
    """``init_cache``'s shapes and dtypes and ``cache_slot_axes`` equal the
    reference's; insert / extract / keep act on each entry's own slot axis
    (``ssm``/``conv`` on axis 2, K/V on axis 1)."""
    jcfg, cfg, _, mp, _, _ = models.get("dense")
    c = T.init_cache(cfg, 3, 16, device="cpu")
    jc = JT.init_cache(jcfg, 3, 16)
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: tuple(v.shape) for k, v in jc.items()}
    assert c["ssm"].dtype == torch.float32 and c["conv"].dtype == cfg.activation_dtype
    assert T.cache_slot_axes(cfg) == JT.cache_slot_axes(jcfg) == {
        "pos": 0, "k": 1, "v": 1, "ssm": 2, "conv": 2}
    _, one = T.prefill(cfg, mp, torch.from_numpy(_tokens(cfg, (1, 6))), max_len=16)
    T.cache_insert(cfg, c, one, 2)
    back = T.cache_extract(cfg, c, 2)
    for name in one:
        assert torch.equal(back[name], one[name].to(back[name].dtype)), name
    assert not c["ssm"][:, :, :2].any() and not c["k"][:, :2].any()
    new = {k: v + 1 for k, v in c.items()}
    kept = T.cache_keep(cfg, c, new, torch.tensor([True, False, True]))
    for name, axis in T.cache_slot_axes(cfg).items():
        for s, keep in enumerate((True, False, True)):
            src = c if keep and name in T.STEP_STATE else new
            assert torch.equal(kept[name].narrow(axis, s, 1), src[name].narrow(axis, s, 1)), \
                (name, s)


def test_xnor_experts_are_refused_on_both_sides(models):
    """An xnor plan packs every projection (as the reference's does), but
    neither side can apply the MoE layers' experts: the reference's
    ``_expert_matmul`` takes no XnorLinear, the port's raises naming that."""
    jcfg, cfg, jp, mp, _, _ = models.get("dense")
    jpp = j_compile_plan(jp, J_POLICY, "xnor").pack(jp)
    pp = compile_plan(mp, DEFAULT_POLICY, "xnor").pack(mp)
    toks = _tokens(cfg, (2, 1))
    with pytest.raises(AttributeError, match="astype"):
        JT.decode_step(jcfg, jpp, JT.init_cache(jcfg, 2, 8), jnp.asarray(toks))
    with pytest.raises(NotImplementedError, match="takes no XnorLinear"):
        T.decode_step(cfg, pp, T.init_cache(cfg, 2, 8, device="cpu"), torch.from_numpy(toks))
