"""The port's SSM family (``models.ssm``, the ``ssm`` branches of
``models.transformer``, its plans and stacked packing) against the reference
on the CPU.

Module inputs are drawn with numpy from fixed seeds and fed to both sides.
Model parity carries the reference's master weights (``init_lm`` at key 0,
mamba2-130m's SMOKE config) into the port with ``interop.from_jax_tree``,
and each side packs them at the same key. Tolerances are the reference's own
for the SSM (``tests/test_models.py`` TestSSM, ``tests/test_serving.py``):

* ``ssd_chunked`` against the plain recurrence, chunk 8, 32 and 64: rtol
  1e-3 / atol 1e-4, on both sides; the port against the reference's chunked
  scan, with and without a carried-in state: ``TOL`` (1e-4), as the port's
  other f32 parity tests (the port sums in f64 and rounds once, the
  reference in f32);
* ``_causal_conv``, ``ssm_forward`` (a padded length, ``return_state``, and
  two calls threaded through ``initial_state`` / ``conv_state``) and
  ``ssm_decode_step``: ``TOL``;
* the model's ``forward``, ``prefill``, ``decode_step`` and
  ``prefill_chunk`` in dense / det / stoch / xnor: ``TOL`` (the SMOKE config
  is f32; xnor's popcounts are exact);
* decode against forward within the port: rtol 5e-2 / atol 5e-3; packed
  against binarized-dense masters: 5e-2;
* the plans equal the reference's as dicts in det, stoch and xnor (the
  stacked 3-D ``conv`` leaf's sharding column included), and the stacked
  ``in_proj`` / ``out_proj`` words, stochastic ones too, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import base as cb
from repro_torch.core import binarize as B
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.kernels import ops
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear, XnorLinear

ARCH = "mamba2_130m"
MODES = ("dense", "det", "stoch", "xnor")
TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-3, atol=1e-4)          # chunked scan against the recurrence
DECODE_TOL = dict(rtol=5e-2, atol=5e-3)        # decode against forward
PACK_SEED = 7


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _ssd_inputs(b=2, s=64, h=3, p=8, n=16, seed=0):
    """(x, dt, a, B, C) as the reference's TestSSM draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0.0).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


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
# the mixer's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_ssd_chunked_matches_the_reference(chunk, carried):
    x, dt, a, bm, cm = _ssd_inputs()
    init = (np.random.default_rng(5).normal(size=(2, 3, 8, 16)).astype(np.float32)
            if carried else None)
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                             init_state=None if init is None else jnp.asarray(init))
    y, st = S.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk,
                          init_state=None if init is None else torch.from_numpy(init))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    np.testing.assert_allclose(_t(y), _np(jy), **TOL)
    np.testing.assert_allclose(_t(st), _np(jst), **TOL)
    if not carried:
        # both sides' chunked scans hold the reference's recurrence oracle
        y_ref, st_ref = JS.ssd_reference(*map(jnp.asarray, (x, dt, a, bm, cm)))
        np.testing.assert_allclose(_t(y), _np(y_ref), **SCAN_TOL)
        np.testing.assert_allclose(_t(st), _np(st_ref), **SCAN_TOL)
        np.testing.assert_allclose(_np(jy), _np(y_ref), **SCAN_TOL)
    else:
        # a carried state continues the scan: the second half from the first
        # half's state is the whole scan's second half
        t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
        half = [v[:, :32] if v.ndim > 1 else v for v in t]
        rest = [v[:, 32:] if v.ndim > 1 else v for v in t]
        y0, st0 = S.ssd_chunked(*half, min(chunk, 32))
        y1, st1 = S.ssd_chunked(*rest, min(chunk, 32), init_state=st0)
        yw, stw = S.ssd_chunked(*t, chunk)
        np.testing.assert_allclose(_t(torch.cat([y0, y1], 1)), _t(yw), **TOL)
        np.testing.assert_allclose(_t(st1), _t(stw), **TOL)


def test_ssd_reference_matches_the_reference():
    x, dt, a, bm, cm = _ssd_inputs(s=24)
    jy, jst = JS.ssd_reference(*map(jnp.asarray, (x, dt, a, bm, cm)))
    y, st = S.ssd_reference(*map(torch.from_numpy, (x, dt, a, bm, cm)))
    np.testing.assert_allclose(_t(y), _np(jy), **TOL)
    np.testing.assert_allclose(_t(st), _np(jst), **TOL)


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_the_reference(history):
    rng = np.random.default_rng(2)
    xbc = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = (0.1 * rng.normal(size=(4, 24))).astype(np.float32)
    hist = rng.normal(size=(2, 3, 24)).astype(np.float32) if history else None
    want = JS._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                           history=None if hist is None else jnp.asarray(hist))
    got = S._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                         history=None if hist is None else torch.from_numpy(hist))
    np.testing.assert_allclose(_t(got), _np(want), **TOL)
    if not history:
        # no history is a zero history, bit for bit
        zeros = torch.zeros((2, 3, 24))
        assert torch.equal(got, S._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                                               history=zeros))


def _layer0(models, mode="dense"):
    jcfg, cfg, jp, mp, _, _ = models.get(mode)
    return (jcfg, cfg, jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
            T.layer_params(mp["layers"]["ssm"], 0))


def _hidden(cfg, b, s, seed=3):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("mode", ["dense", "det", "xnor"])
def test_ssm_forward_matches_the_reference(models, mode):
    """A length that pads (20 tokens in chunks of 8), with ``return_state``."""
    jcfg, cfg, jl, pl = _layer0(models, mode)
    x = _hidden(cfg, 2, 20)
    jout, jst, jtail = JS.ssm_forward(jcfg, jl, jnp.asarray(x), chunk=8, return_state=True)
    out, st, tail = S.ssm_forward(cfg, pl, torch.from_numpy(x), chunk=8, return_state=True)
    assert out.shape == (2, 20, cfg.d_model) and tail.shape == (2, 3, cfg.d_inner + 32)
    np.testing.assert_allclose(_t(out), _np(jout), **TOL)
    np.testing.assert_allclose(_t(st), _np(jst), **TOL)
    np.testing.assert_allclose(_t(tail), _np(jtail), **TOL)
    plain = S.ssm_forward(cfg, pl, torch.from_numpy(x), chunk=8)
    assert torch.equal(plain, out)


def test_ssm_forward_threads_its_state_across_calls(models):
    """Two calls threaded through ``initial_state`` / ``conv_state`` (the
    second shorter than the conv width) against one whole call, on both
    sides and across them."""
    jcfg, cfg, jl, pl = _layer0(models)
    x = _hidden(cfg, 2, 14, seed=4)
    out, st, tail = S.ssm_forward(cfg, pl, torch.from_numpy(x), chunk=4, return_state=True)
    o1, s1, t1 = S.ssm_forward(cfg, pl, torch.from_numpy(x[:, :12]), chunk=4,
                               return_state=True)
    o2, s2, t2 = S.ssm_forward(cfg, pl, torch.from_numpy(x[:, 12:]), chunk=4,
                               return_state=True, initial_state=s1, conv_state=t1)
    assert t2.shape == tail.shape
    np.testing.assert_allclose(_t(torch.cat([o1, o2], 1)), _t(out), **TOL)
    np.testing.assert_allclose(_t(s2), _t(st), **TOL)
    assert torch.equal(t2, tail)
    jo1, js1, jt1 = JS.ssm_forward(jcfg, jl, jnp.asarray(x[:, :12]), chunk=4,
                                   return_state=True)
    jo2, js2, jt2 = JS.ssm_forward(jcfg, jl, jnp.asarray(x[:, 12:]), chunk=4,
                                   return_state=True, initial_state=js1, conv_state=jt1)
    np.testing.assert_allclose(_t(o2), _np(jo2), **TOL)
    np.testing.assert_allclose(_t(s2), _np(js2), **TOL)
    np.testing.assert_allclose(_t(t2), _np(jt2), **TOL)


@pytest.mark.parametrize("mode", ["dense", "stoch", "xnor"])
def test_ssm_decode_step_matches_the_reference(models, mode):
    jcfg, cfg, jl, pl = _layer0(models, mode)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    st = (0.3 * rng.normal(size=(3, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
          ).astype(np.float32)
    cv = rng.normal(size=(3, 3, cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)
    jout, jst, jcv = JS.ssm_decode_step(jcfg, jl, *map(jnp.asarray, (x, st, cv)))
    out, nst, ncv = S.ssm_decode_step(cfg, pl, *map(torch.from_numpy, (x, st, cv)))
    np.testing.assert_allclose(_t(out), _np(jout), **TOL)
    np.testing.assert_allclose(_t(nst), _np(jst), **TOL)
    np.testing.assert_allclose(_t(ncv), _np(jcv), **TOL)
    assert torch.equal(ncv[:, :2], torch.from_numpy(cv[:, 1:]))


def test_softplus_is_the_reference_form():
    """``logaddexp(x, 0)``: past ``F.softplus``'s threshold too."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(_t(S._softplus(torch.from_numpy(x))),
                               _np(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the model: init, plans, words
# ---------------------------------------------------------------------------

def test_port_init_has_the_reference_tree(models):
    jcfg, cfg, jp, _, _, _ = models.get("dense")
    mine = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p: tuple(v.shape) for p, v in tree_leaves_with_path(mine)} == {
        p: tuple(v.shape) for p, v in tree_leaves_with_path(from_jax_tree(jp, device="cpu"))}
    ssm = mine["layers"]["ssm"]
    np.testing.assert_allclose(_t(ssm["A_log"]), _np(jp["layers"]["ssm"]["A_log"]),
                               rtol=1e-6)
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    assert not torch.equal(ssm["in_proj"][0], ssm["in_proj"][1])


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_plans_and_stacked_words_equal_the_reference(models, mode):
    jcfg, cfg, jpp, pp, jplan, plan = models.get(mode)
    assert plan.to_json() == jplan.to_json()
    assert plan["layers/ssm/conv"].sharding == [None, None, "model"]
    assert plan["layers/ssm/out_proj"].sharding == (
        [None, "model", None] if mode == "xnor" else plan["layers/ssm/out_proj"].sharding)
    want = "xnor" if mode == "xnor" else "packed"
    assert {r.path for r in plan.assignments(want)} == {"layers/ssm/in_proj",
                                                       "layers/ssm/out_proj"}
    ref = dict(zip([p for p, _ in tree_leaves_with_path(pp)],
                   jax.tree_util.tree_leaves(jpp, is_leaf=lambda x: hasattr(x, "packed"))))
    for name in ("in_proj", "out_proj"):
        leaf, r = pp["layers"]["ssm"][name], ref[f"layers/ssm/{name}"]
        assert type(leaf) is (XnorLinear if mode == "xnor" else PackedLinear)
        assert type(leaf).__name__ == type(r).__name__
        assert leaf.packed.shape[0] == cfg.n_layers
        np.testing.assert_array_equal(leaf.packed.numpy(), np.asarray(r.packed), err_msg=name)
        np.testing.assert_allclose(leaf.scale.numpy(), np.asarray(r.scale), rtol=1e-6)
        assert leaf.master_shape == tuple(r.master_shape)
    for path, leaf in tree_leaves_with_path(pp):
        if not path.endswith("_proj"):
            assert isinstance(leaf, torch.Tensor), path


def test_stoch_layer_words_come_from_split_keys(models):
    _, cfg, _, mp, _, _ = models.get("dense")
    _, _, _, pp, _, plan = models.get("stoch")
    row = plan["layers/ssm/in_proj"]
    keys = prng.split(prng.fold_in(prng.key(PACK_SEED), row.index), cfg.n_layers)
    w = mp["layers"]["ssm"]["in_proj"]
    for layer in range(cfg.n_layers):
        want = ops.binarize_and_pack(w[layer], keys[layer], stochastic=True)
        assert torch.equal(pp["layers"]["ssm"]["in_proj"][layer].packed, want)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode, chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_the_reference(models, mode):
    jcfg, cfg, jpp, pp, _, _ = models.get(mode)
    toks = _tokens(cfg, (2, 16))
    want, _ = _jit_forward(jcfg, jpp, toks)
    got, aux = T.forward(cfg, pp, torch.from_numpy(toks))
    assert got.shape == (2, 16, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_t(got), _np(want), **TOL)
    assert float(aux["lb_loss"]) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_the_reference(models, mode):
    jcfg, cfg, jpp, pp, _, _ = models.get(mode)
    toks = _tokens(cfg, (2, 12))
    jlg, jc = _jit_prefill(jcfg, jpp, toks, 16)
    lg, c = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(_t(lg), _np(jlg), **TOL)
    assert set(c) == set(jc) == {"pos", "ssm", "conv"}
    for name in ("ssm", "conv"):
        assert c[name].shape == jc[name].shape
        np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL)
    for step in range(3):
        tok = np.argmax(_np(jlg), axis=-1).astype(np.int32)[:, None]
        jlg, jc = _jit_decode(jcfg, jpp, jc, tok)
        old = c["ssm"].clone()
        ssm_before = c["ssm"]
        lg, c = T.decode_step(cfg, pp, c, torch.from_numpy(tok))
        assert torch.equal(ssm_before, old)             # returned anew, not in place
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL)


def test_decode_matches_forward(models):
    """The reference's TestSSM row, within the port: prefill 16 tokens, then
    decode 17 more against the full forward's logits."""
    _, cfg, _, mp, _, _ = models.get("dense")
    toks = torch.from_numpy(_tokens(cfg, (1, 33), seed=2))
    logits, _ = T.forward(cfg, mp, toks)
    lp, cache = T.prefill(cfg, mp, toks[:, :16], max_len=33)
    np.testing.assert_allclose(_t(lp), _t(logits[:, 15]), **DECODE_TOL)
    for t in range(16, 33):
        ld, cache = T.decode_step(cfg, mp, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(_t(ld), _t(logits[:, t]), **DECODE_TOL, err_msg=f"{t}")


@pytest.mark.parametrize("mode", ["dense", "xnor"])
def test_prefill_chunk_matches_the_reference(models, mode):
    """Slot 1 of 2 prefilled in chunks of 5, 5 and 2 (the last shorter than
    the conv width) over a stale occupant: the state, conv window and
    logits of each chunk equal the reference's, and the whole-prompt
    prefill's within ``TOL``; slot 0 is untouched."""
    jcfg, cfg, jpp, pp, _, _ = models.get(mode)
    toks = _tokens(cfg, (1, 12), seed=5)
    stale = np.random.default_rng(7).normal(size=(cfg.n_layers, 2, cfg.ssm_heads,
                                                  cfg.ssm_head_dim, cfg.ssm_state))
    jc = dict(JT.init_cache(jcfg, 2, 16), ssm=jnp.asarray(stale, jnp.float32))
    c = T.init_cache(cfg, 2, 16, device="cpu")
    c["ssm"].copy_(torch.from_numpy(stale))
    slot0 = c["ssm"][:, 0].clone()
    off = 0
    for n in (5, 5, 2):
        chunk = toks[:, off:off + n]
        jlg, jc = JT.prefill_chunk(jcfg, jpp, jc, jnp.asarray(chunk), 1, off)
        lg, c = T.prefill_chunk(cfg, pp, c, torch.from_numpy(chunk), 1, off)
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"{off}")
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL)
        assert c["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        off += n
    assert torch.equal(c["ssm"][:, 0], slot0)
    wlg, wc = T.prefill(cfg, pp, torch.from_numpy(toks), max_len=16)
    np.testing.assert_allclose(_t(lg), _t(wlg), **TOL)
    np.testing.assert_allclose(_t(c["ssm"][:, 1:2]), _t(wc["ssm"]), **TOL)
    assert torch.equal(c["conv"][:, 1:2], wc["conv"])


def test_cache_layout_and_slot_ops(models):
    jcfg, cfg, _, mp, _, _ = models.get("dense")
    c = T.init_cache(cfg, 3, 16, device="cpu")
    jc = JT.init_cache(jcfg, 3, 16)
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    assert c["ssm"].dtype == torch.float32 and c["conv"].dtype == cfg.activation_dtype
    assert T.cache_slot_axes(cfg) == JT.cache_slot_axes(jcfg) == {"pos": 0, "ssm": 1,
                                                                  "conv": 1}
    _, one = T.prefill(cfg, mp, torch.from_numpy(_tokens(cfg, (1, 6))))
    T.cache_insert(cfg, c, one, 2)
    back = T.cache_extract(cfg, c, 2)
    for name in one:
        assert torch.equal(back[name], one[name].to(back[name].dtype)), name
    assert not c["ssm"][:, :2].any() and not c["conv"][:, :2].any()
    new = {k: v + 1 for k, v in c.items()}
    kept = T.cache_keep(cfg, c, new, torch.tensor([True, False, True]))
    for name, axis in T.cache_slot_axes(cfg).items():
        for s, keep in enumerate((True, False, True)):
            want = (c if keep else new)[name].narrow(axis, s, 1)
            assert torch.equal(kept[name].narrow(axis, s, 1), want), (name, s)


def test_packed_equals_binarized_dense(models):
    """The reference's ``test_packed_equals_binarized_dense`` row for the
    SSM template: unscaled det-packed inference against the dense forward on
    det-binarized masters."""
    _, cfg, _, mp, _, _ = models.get("dense")
    toks = torch.from_numpy(_tokens(cfg, (2, 16)))
    dense_b = B.binarize_tree(mp, "det", DEFAULT_POLICY)
    want, _ = T.forward(cfg, dense_b, toks)
    packed = compile_plan(mp, DEFAULT_POLICY, "det", with_scale=False).pack(mp)
    got, _ = T.forward(cfg, packed, toks)
    np.testing.assert_allclose(_t(got), _t(want), rtol=5e-2, atol=5e-2)


def test_hybrid_and_frontend_families_still_raise():
    """The frontend families, once refused, are ported: a prefill from the
    stub's embeddings, then two decode steps, each from an embedding, give
    the reference's logits and cache."""
    from repro.models import frontends as JF
    from repro_torch.models import frontends as F

    for arch in ("musicgen_large", "internvl2_76b"):
        jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        mp = from_jax_tree(jp, device="cpu")
        jx = JF.STUBS[jcfg.frontend](jax.random.key(5), 2, 8, jcfg.d_model)
        x = F.STUBS[cfg.frontend](prng.key(5), 2, 8, cfg.d_model)
        jlg, jc = JT.prefill(jcfg, jp, jx[:, :6], max_len=8)
        lg, c = T.prefill(cfg, mp, x[:, :6], max_len=8)
        for i in (6, 7):
            np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"{arch} {i}")
            jlg, jc = JT.decode_step(jcfg, jp, jc, jx[:, i:i + 1])
            lg, c = T.decode_step(cfg, mp, c, x[:, i:i + 1])
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=arch)
        for name in jc:
            np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL, err_msg=name)
