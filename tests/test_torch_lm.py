"""The port's dense LM stack (``configs``, ``models.{layers, attention, mlp,
transformer}``, stacked packing, ``interop``) against the reference on the
CPU.

Reference master weights (``repro.models.transformer.init_lm`` at key 0)
are carried into the port with ``interop.from_jax_tree``; the reference
packs them (its Pallas kernels in interpret mode where its ops pick them)
and the port packs the same masters. For the four dense SMOKE archs and
det / stoch / xnor / dense:

* the compiled plans are equal, and the stacked packed words equal the
  reference's bit for bit (stoch at the same key: layer l draws from
  ``split(fold_in(key, index), L)[l]``); scales agree to f32 rounding;
* ``forward``, ``prefill`` (logits and the cache) and three
  ``decode_step``s hold rtol 1e-4 / atol 1e-4 in f32 (the SMOKE configs
  are f32; only the order of f32 sums differs, and in xnor the popcounts
  are exact).

A bf16 variant of starcoder2's SMOKE config holds a looser bound,
``BF16_LOGIT_TOL`` (see there). Flash attention equals dense attention with
and without a window, and a sliding-window ring (window 8, contexts past
it) decodes as the reference does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear, XnorConv, XnorLinear

DENSE_ARCHS = ("starcoder2_3b", "qwen2_5_32b", "deepseek_coder_33b", "h2o_danube_3_4b")
MODES = ("det", "stoch", "xnor", "dense")
TOL = dict(rtol=1e-4, atol=1e-4)
PACK_SEED = 7
# bf16 activations: both sides round every op's output to bf16 (8
# significant bits), but XLA's CPU may keep f32 between fused elementwise
# ops where torch rounds each one, so the two differ by a few bf16 ulps of
# the logits' scale (|logit| <= ~4 here, one ulp = 2^-6): 4 ulps.
BF16_LOGIT_TOL = dict(rtol=0.0, atol=4 * 2.0 ** -6)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


class _Models:
    """Reference and port trees per (arch, mode), built once per module."""

    def __init__(self):
        self._cache = {}

    def masters(self, arch, dtype=None):
        key = ("masters", arch, dtype)
        if key not in self._cache:
            jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
            if dtype is not None:
                jcfg = dataclasses.replace(jcfg, dtype=dtype)
                cfg = dataclasses.replace(cfg, dtype=dtype)
            jp = JT.init_lm(jcfg, jax.random.key(0))
            self._cache[key] = (jcfg, cfg, jp, from_jax_tree(jp, device="cpu"))
        return self._cache[key]

    def packed(self, arch, mode, dtype=None):
        """(jcfg, cfg, reference tree, port tree packed from the same
        masters, reference plan, port plan)."""
        key = ("packed", arch, mode, dtype)
        if key not in self._cache:
            jcfg, cfg, jp, mp = self.masters(arch, dtype)
            if mode == "dense":
                self._cache[key] = (jcfg, cfg, jp, mp, None, None)
            else:
                jplan = j_compile_plan(jp, J_POLICY, mode)
                plan = compile_plan(mp, DEFAULT_POLICY, mode)
                self._cache[key] = (jcfg, cfg, jplan.pack(jp, key=jax.random.key(PACK_SEED)),
                                    plan.pack(mp, key=prng.key(PACK_SEED)), jplan, plan)
        return self._cache[key]


@pytest.fixture(scope="module")
def models():
    return _Models()


_jit_forward = jax.jit(JT.forward, static_argnums=0)
_jit_prefill = jax.jit(lambda cfg, p, t, max_len: JT.prefill(cfg, p, t, max_len=max_len),
                       static_argnums=(0, 3))
_jit_decode = jax.jit(JT.decode_step, static_argnums=0)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in jcb.ARCH_IDS
                                  if a not in ("mnist_fc", "vgg16_cifar10")])
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        j, p = jcb.get_config(arch, smoke=smoke), cb.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert p.activation_dtype == getattr(torch, j.dtype)
        assert (p.q_dim, p.kv_dim, p.d_inner, p.n_attn_layers()) == (
            j.q_dim, j.kv_dim, j.d_inner, j.n_attn_layers())
        assert p.param_count() == j.param_count()
        assert p.param_count(active_only=True) == j.param_count(active_only=True)
        assert cb.shapes_for(p) == {k: cb.ShapeSpec(*dataclasses.astuple(v))
                                    for k, v in jcb.shapes_for(j).items()}


def test_registry_names_and_aliases():
    assert cb.ARCH_IDS == jcb.ARCH_IDS
    for alias in ("starcoder2-3b", "qwen2.5-32b", "jamba-1.5-large", " mamba2-130m "):
        assert cb.canonical_arch(alias) == jcb.canonical_arch(alias)
    assert cb.get_config("starcoder2-3b").name == "starcoder2-3b"


@pytest.mark.parametrize("arch", ["musicgen_large", "internvl2_76b"])
def test_other_families_raise_naming_the_roadmap(arch):
    """The frontend families, once refused, are ported: their masters and
    decode cache have the reference's tree, shapes and dtypes."""
    jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: JT.init_lm(jcfg, jax.random.key(0)))
    assert [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(params)] == [
        (p, tuple(a.shape)) for p, a in tree_leaves_with_path(want)]
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    jcache = JT.init_cache(jcfg, 1, 8)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "grok_1_314b"])
def test_moe_families_init_and_serve(arch):
    """The MoE family runs: its init has stacked ``layers/moe`` (router
    (L, D, E), experts (L, E, ...)) in place of ``mlp``, and a packed det
    engine serves greedy tokens equal to the stepwise forward's."""
    from repro_torch.serve import ServeEngine

    cfg = cb.get_config(arch, smoke=True)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    moe = params["layers"]["moe"]
    assert "mlp" not in params["layers"]
    assert moe["router"].shape == (cfg.n_layers, cfg.d_model, cfg.n_experts)
    up = moe["w_up" if cfg.mlp_type == "glu" else "wi"]
    assert up.shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert T.init_cache(cfg, 2, 8, device="cpu")["k"].shape[0] == cfg.n_layers
    packed = compile_plan(params, DEFAULT_POLICY, "det").pack(params)
    prompts = torch.from_numpy(_tokens(cfg, (2, 6)))
    out = ServeEngine(cfg, packed).generate(prompts, max_new=3)
    seq = prompts
    for i in range(3):
        logits, aux = T.forward(cfg, packed, seq)
        assert float(aux["lb_loss"]) > 0.0
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        assert torch.equal(nxt, out.tokens[:, i])
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_port_init_has_the_reference_tree(models):
    """The port's own init draws from a torch.Generator, so its values
    differ, but its tree (paths, shapes, dtypes) is the reference's, so
    plans and manifests line up."""
    for arch in DENSE_ARCHS:
        _, cfg, jp, _ = models.masters(arch)
        mine = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        ref = {p: (tuple(v.shape), str(v.dtype))
               for p, v in tree_leaves_with_path(from_jax_tree(jp, device="cpu"))}
        assert {p: (tuple(v.shape), str(v.dtype))
                for p, v in tree_leaves_with_path(mine)} == ref


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norms_and_rope_match_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(32,)).astype(np.float32) * 0.1
    jx = jnp.asarray(x, dtype)
    tx = from_jax_tree(jx, device="cpu")
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    tol = TOL if dtype == jnp.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_t(L.rms_norm(tx, ts)), _np(JL.rms_norm(jx, scale)), **tol)
    np.testing.assert_allclose(_t(L.layer_norm(tx, ts, tb)),
                               _np(JL.layer_norm(jx, scale, bias)), **tol)
    pos = np.array([[0, 3, 7, 40, 1000], [5, 6, 7, 8, 9]], np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _t(L.apply_rope(tx, torch.from_numpy(pos), theta)),
            _np(JL.apply_rope(jx, jnp.asarray(pos), theta)), **tol)
        np.testing.assert_allclose(
            _t(L.apply_rope(tx, torch.from_numpy(pos[0]), theta)),
            _np(JL.apply_rope(jx, jnp.asarray(pos[0]), theta)), **tol)
    assert L.rms_norm(tx, ts).dtype == tx.dtype == L.apply_rope(tx, torch.from_numpy(pos),
                                                                1e4).dtype


def test_embed_lookup_and_bf16_interop():
    emb = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    toks = np.array([[3, 0, 49], [7, 7, 1]], np.int32)
    want = JL.embed_lookup(jnp.asarray(emb), jnp.asarray(toks), jnp.bfloat16)
    got = L.embed_lookup(torch.from_numpy(emb), torch.from_numpy(toks), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    carried = from_jax_tree({"e": want}, device="cpu")["e"]      # bf16 through interop
    assert carried.dtype == torch.bfloat16 and torch.equal(carried, got)


def test_stacked_leaves_slice_and_report_master_shape():
    pl = PackedLinear(torch.zeros((5, 2, 64, 7), dtype=torch.int32), None, 64)
    assert pl.master_shape == (5, 2, 64, 7)
    xl = XnorLinear(torch.arange(3 * 2 * 4, dtype=torch.int32).reshape(3, 2, 4),
                    torch.arange(12, dtype=torch.float32).reshape(3, 4), 64)
    one = xl[1]
    assert type(one) is XnorLinear and one.master_shape == (64, 4) and one.k == 64
    assert torch.equal(one.packed, xl.packed[1]) and torch.equal(one.scale, xl.scale[1])
    with pytest.raises(IndexError):
        one[0]
    xc = XnorConv(torch.zeros((9, 4), dtype=torch.int32), None, (3, 3), 20)
    assert xc.master_shape == (3, 3, 20, 4)


# ---------------------------------------------------------------------------
# stacked packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_stacked_words_equal_the_reference(models, arch, mode):
    jcfg, cfg, jpp, pp, jplan, plan = models.packed(arch, mode)
    assert plan.to_json() == jplan.to_json()
    ref = dict(zip([p for p, _ in tree_leaves_with_path(pp)],
                   jax.tree_util.tree_leaves(jpp, is_leaf=lambda x: hasattr(x, "packed"))))
    n_packed = 0
    for path, leaf in tree_leaves_with_path(pp):
        r = ref[path]
        if not hasattr(r, "packed"):
            assert isinstance(leaf, torch.Tensor)
            continue
        n_packed += 1
        assert type(leaf).__name__ == type(r).__name__
        assert leaf.packed.shape[0] == cfg.n_layers        # the stack dim kept
        np.testing.assert_array_equal(leaf.packed.numpy(), np.asarray(r.packed), err_msg=path)
        np.testing.assert_allclose(leaf.scale.numpy(), np.asarray(r.scale), rtol=1e-6,
                                   err_msg=path)
        assert leaf.master_shape == tuple(r.master_shape)
    assert n_packed == (5 if cfg.mlp_type == "glu" else 4)


def test_stoch_layer_words_come_from_split_keys(models):
    """Layer l of a stacked stochastic leaf equals a 2-D pack of that
    layer at ``split(fold_in(key, index), L)[l]``."""
    from repro_torch.kernels import ops

    _, cfg, _, mp = models.masters("starcoder2_3b")
    _, _, _, pp, _, plan = models.packed("starcoder2_3b", "stoch")
    row = plan["layers/mlp/wi"]
    keys = prng.split(prng.fold_in(prng.key(PACK_SEED), row.index), cfg.n_layers)
    w = mp["layers"]["mlp"]["wi"]
    for layer in range(cfg.n_layers):
        want = ops.binarize_and_pack(w[layer], keys[layer], stochastic=True)
        assert torch.equal(pp["layers"]["mlp"]["wi"][layer].packed, want)
    assert not torch.equal(pp["layers"]["mlp"]["wi"].packed[0],
                           pp["layers"]["mlp"]["wi"].packed[1])


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_the_reference(models, arch, mode):
    jcfg, cfg, jpp, pp, _, _ = models.packed(arch, mode)
    toks = _tokens(cfg, (2, 16))
    want, _ = _jit_forward(jcfg, jpp, toks)
    got, aux = T.forward(cfg, pp, torch.from_numpy(toks))
    assert got.shape == (2, 16, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_t(got), _np(want), **TOL)
    assert float(aux["lb_loss"]) == 0.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_the_reference(models, arch, mode):
    jcfg, cfg, jpp, pp, _, _ = models.packed(arch, mode)
    toks = _tokens(cfg, (2, 12))
    jlg, jc = _jit_prefill(jcfg, jpp, toks, 16)
    lg, c = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(_t(lg), _np(jlg), **TOL)
    assert set(c) == set(jc) and c["k"].shape == jc["k"].shape
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL)
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    for step in range(3):
        tok = np.argmax(_np(jlg), axis=-1).astype(np.int32)[:, None]
        jlg, jc = _jit_decode(jcfg, jpp, jc, tok)
        lg, c = T.decode_step(cfg, pp, c, torch.from_numpy(tok))
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(_t(c["k"]), _np(jc["k"]), **TOL)


def test_bf16_smoke_variant_within_the_stated_tolerance(models):
    """starcoder2's SMOKE config with bf16 activations, packed det: the
    carry, the cache and the logits stay bf16 as the reference's."""
    jcfg, cfg, jpp, pp, _, _ = models.packed("starcoder2_3b", "det", dtype="bfloat16")
    toks = _tokens(cfg, (2, 12))
    jlg, jc = _jit_prefill(jcfg, jpp, toks, 16)
    lg, c = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    assert lg.dtype == c["k"].dtype == torch.bfloat16 and str(jlg.dtype) == "bfloat16"
    np.testing.assert_allclose(_t(lg), _np(jlg), **BF16_LOGIT_TOL)
    tok = np.argmax(_np(jlg), axis=-1).astype(np.int32)[:, None]
    jlg2, _ = _jit_decode(jcfg, jpp, jc, tok)
    lg2, _ = T.decode_step(cfg, pp, c, torch.from_numpy(tok))
    np.testing.assert_allclose(_t(lg2), _np(jlg2), **BF16_LOGIT_TOL)
    want, _ = _jit_forward(jcfg, jpp, toks)
    got, _ = T.forward(cfg, pp, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_t(got), _np(want), **BF16_LOGIT_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
def test_flash_equals_dense_attention(window):
    """The chunked online softmax equals the one-block softmax (and the
    reference's flash) at S = 4 chunks, causal, with and without a window."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32) for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = A.flash_attention(tq, tk, tv, window=window, chunk_q=16, chunk_k=16)
    cfg = dataclasses.replace(cb.get_config("starcoder2_3b", smoke=True), head_dim=16,
                              n_heads=4, n_kv_heads=4, sliding_window=window)
    dense = A._sdpa(cfg, tq, tk, tv, 64)
    np.testing.assert_allclose(_t(got), _t(dense), rtol=1e-5, atol=1e-5)
    want = JA.flash_attention(q, k, v, window=window, chunk_q=16, chunk_k=16)
    np.testing.assert_allclose(_t(got), _np(want), **TOL)


def test_sdpa_takes_flash_from_the_threshold(monkeypatch):
    calls = []
    monkeypatch.setattr(A, "flash_attention", lambda *a, **kw: calls.append(kw) or a[0])
    cfg = cb.get_config("h2o_danube_3_4b", smoke=True)
    x = torch.zeros((1, A.FLASH_THRESHOLD, 1, 4))
    A._sdpa(cfg, x, x, x, A.FLASH_THRESHOLD)
    assert calls == [{"window": cfg.sliding_window}]


def test_sliding_window_ring_decode_matches_the_reference():
    """h2o-danube's SMOKE config with an 8-token window: a 12-token prefill
    lands in the ring rolled (positions p at slot p % 8) and 6 decode steps
    wrap it, masking by token age, as the reference does."""
    base_j, base = (jcb.get_config("h2o_danube_3_4b", smoke=True),
                    cb.get_config("h2o_danube_3_4b", smoke=True))
    jcfg = dataclasses.replace(base_j, sliding_window=8)
    cfg = dataclasses.replace(base, sliding_window=8)
    jp = JT.init_lm(jcfg, jax.random.key(0))
    pp = from_jax_tree(jp, device="cpu")
    toks = _tokens(cfg, (2, 12), seed=5)
    jlg, jc = _jit_prefill(jcfg, jp, toks, 18)
    lg, c = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=18)
    assert c["k"].shape[2] == A.cache_length(cfg, 18) == 8
    np.testing.assert_allclose(_t(lg), _np(jlg), **TOL)
    np.testing.assert_allclose(_t(c["k"]), _np(jc["k"]), **TOL)
    for step in range(6):
        tok = np.argmax(_np(jlg), axis=-1).astype(np.int32)[:, None]
        jlg, jc = _jit_decode(jcfg, jp, jc, tok)
        lg, c = T.decode_step(cfg, pp, c, torch.from_numpy(tok))
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"step {step}")
        np.testing.assert_allclose(_t(c["v"]), _np(jc["v"]), **TOL, err_msg=f"step {step}")


def test_causal_mask_matches_the_reference():
    for window, off in ((None, 0), (3, 0), (3, 5)):
        np.testing.assert_array_equal(A.causal_mask(6, 9, window, off).numpy(),
                                      np.asarray(JA.causal_mask(6, 9, window, off)))


# ---------------------------------------------------------------------------
# the slot-addressed cache
# ---------------------------------------------------------------------------

def test_cache_insert_extract_keep(models):
    _, cfg, _, mp = models.masters("starcoder2_3b")
    cache = T.init_cache(cfg, 3, 10, device="cpu")
    _, one = T.prefill(cfg, mp, torch.from_numpy(_tokens(cfg, (1, 6))), max_len=10)
    before = {k: v.clone() for k, v in cache.items()}
    assert T.cache_insert(cfg, cache, one, 1) is cache
    got = T.cache_extract(cfg, cache, 1)
    for name in cache:
        assert torch.equal(got[name], one[name].to(cache[name].dtype))
        for s in (0, 2):
            assert torch.equal(T.cache_extract(cfg, cache, s)[name],
                               T.cache_extract(cfg, before, s)[name])
    with pytest.raises(ValueError, match="batch-1"):
        T.cache_insert(cfg, cache, T.init_cache(cfg, 2, 10, device="cpu"), 0)
    with pytest.raises(ValueError, match="out of sync"):
        T.cache_insert(cfg, dict(cache, extra=cache["pos"]), one, 0)
    new = dict(cache, pos=cache["pos"] + 1)
    kept = T.cache_keep(cfg, cache, new, torch.tensor([True, False, True]))
    assert kept["pos"].tolist() == [0, 7, 0] and kept["k"] is new["k"]
