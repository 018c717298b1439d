"""The port's chunked prefill and prefix reuse (``attention.chunk_attention``,
``transformer.prefill_chunk``, ``ServeEngine.{prefill_chunk_into, fused_step,
capture_slot, splice_into}``, ``stream_serve(prefill_chunk=, prefix_cache=)``)
against the reference on the CPU.

Reference master weights (``repro.models.transformer.init_lm`` at key 0) are
carried into the port with ``interop.from_jax_tree``, and each side packs
them at the same key. The SMOKE configs are f32: a chunk's logits, output
and cache rows hold ``TOL`` (rtol 1e-4 / atol 1e-4, only the order of f32
sums differs; xnor's popcounts are exact). Streams are greedy tokens and
must be equal: the port's streams to the port's one-shot ``generate`` (the
reference's conformance invariant) and to the reference's streams on the
same prompts, for {dense, det, xnor} x {whole-prompt, chunked}, cold and
warm prefix caches, and a ring cache whose chunks cross the wrap.
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
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SlotBatcher as JSlotBatcher
from repro.serve import stream_serve as j_stream_serve
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve

ARCH = "starcoder2_3b"
PROMPT_LEN = 8
MAX_NEWS = [3, 5, 2, 4, 3]
CAP = 5
TOL = dict(rtol=1e-4, atol=1e-4)
PACK_SEED = 3


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().to(torch.float32).numpy()


def _cfgs(arch=ARCH, window=None):
    jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return jcfg, cfg


def _trees(jcfg, mode):
    """(reference tree, port tree): the same masters, packed by each side at
    the same key unless ``mode`` is dense."""
    jp = JT.init_lm(jcfg, jax.random.key(0))
    mp = from_jax_tree(jp, device="cpu")
    if mode != "dense":
        jp = j_compile_plan(jp, J_POLICY, mode).pack(jp, key=jax.random.key(PACK_SEED))
        mp = compile_plan(mp, DEFAULT_POLICY, mode).pack(mp, key=prng.key(PACK_SEED))
    return jp, mp


@pytest.fixture(scope="module")
def engines():
    """(cfg, reference engine, port engine) per plan mode, built once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            jcfg, cfg = _cfgs()
            jp, mp = _trees(jcfg, mode)
            cache[mode] = (cfg, JServeEngine(jcfg, jp), ServeEngine(cfg, mp))
        return cache[mode]

    return get


def _prompts(cfg, shared_prefix=True):
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(len(MAX_NEWS), PROMPT_LEN)).astype(np.int32)
    if shared_prefix:
        # request 3 repeats request 0's prompt: with a prefix cache it is
        # admitted mid-stream as a full-prompt hit
        prompts[3] = prompts[0]
    return prompts


def _oracle(engine, prompts, max_news=MAX_NEWS):
    return {i: engine.generate(p[None], m).tokens[0].tolist()
            for i, (p, m) in enumerate(zip(prompts, max_news))}


def _stream(engine, prompts, *, batcher=SlotBatcher, serve=stream_serve, n_slots=2,
            max_news=MAX_NEWS, prompt_len=PROMPT_LEN, cap=CAP, **kw):
    b = batcher(n_slots, prompt_len)
    for p, m in zip(prompts, max_news):
        b.submit(p, m)
    serve(engine, b, max_new_cap=cap, **kw)
    assert b.idle and len(b.completed) == len(max_news)
    return {r.uid: list(r.generated) for r in b.completed}


def _j_stream(engine, prompts, **kw):
    return _stream(engine, prompts, batcher=JSlotBatcher, serve=j_stream_serve, **kw)


# ---------------------------------------------------------------------------
# chunk_attention and prefill_chunk
# ---------------------------------------------------------------------------

# (layout, window, cache rows): a linear cache of 16 rows and a ring of 6;
# a 12-token prompt in chunks at offsets 0, mid-prompt and the last chunk
LAYOUTS = {"linear": (None, 16), "ring": (6, 16)}
CHUNKS = [(0, 5), (5, 5), (10, 2)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chunk_attention_matches_the_reference(layout):
    """Layer 0's attention over caches of random rows (so every masked lane
    holds garbage): the output and the rows written after attention."""
    window, ctx = LAYOUTS[layout]
    jcfg, cfg = _cfgs("h2o_danube_3_4b", window)
    jp, mp = _trees(jcfg, "dense")
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    attn = T.layer_params(mp["layers"], 0)["attn"]
    rng = np.random.default_rng(2)
    s_cache = A.cache_length(cfg, ctx)
    shape = (3, s_cache, cfg.n_kv_heads, cfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    k, v = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for off, c in CHUNKS:
        x = rng.standard_normal((1, c, cfg.d_model)).astype(np.float32)
        jout, jk, jv = JA.chunk_attention(jcfg, jattn, jnp.asarray(x), jk, jv, 1, off)
        out, k, v = A.chunk_attention(cfg, attn, torch.from_numpy(x), k, v, 1, off)
        np.testing.assert_allclose(_t(out), _np(jout), **TOL, err_msg=f"offset {off}")
        np.testing.assert_allclose(_t(k), _np(jk), **TOL, err_msg=f"offset {off}")
        np.testing.assert_allclose(_t(v), _np(jv), **TOL, err_msg=f"offset {off}")
    # the other slots' rows are untouched
    assert np.array_equal(k[[0, 2]].numpy(), kc[[0, 2]])


@pytest.mark.parametrize("mode", ["dense", "det", "xnor"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_chunk_matches_the_reference(layout, mode):
    """Three chunks of one slot of a 3-slot cache: logits, K/V and ``pos``
    after each, and the last chunk's logits and rows against the port's
    whole-prompt prefill."""
    window, ctx = LAYOUTS[layout]
    jcfg, cfg = _cfgs("h2o_danube_3_4b", window)
    jp, mp = _trees(jcfg, mode)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    jc, c = JT.init_cache(jcfg, 3, ctx), T.init_cache(cfg, 3, ctx, device="cpu")
    for off, n in CHUNKS:
        jlg, jc = JT.prefill_chunk(jcfg, jp, jc, jnp.asarray(toks[:, off:off + n]), 1, off)
        lg, c = T.prefill_chunk(cfg, mp, c, torch.from_numpy(toks[:, off:off + n]), 1, off)
        np.testing.assert_allclose(_t(lg), _np(jlg), **TOL, err_msg=f"offset {off}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_t(c[name]), _np(jc[name]), **TOL, err_msg=name)
        assert c["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [0, off + n, 0]
    whole_lg, whole = T.prefill(cfg, mp, torch.from_numpy(toks), max_len=ctx)
    np.testing.assert_allclose(_t(lg), _t(whole_lg), **TOL)
    np.testing.assert_allclose(_t(c["k"][:, 1]), _t(whole["k"][:, 0]), **TOL)


def test_prefill_chunk_refuses_to_run_past_the_cache():
    """The reference's dynamic_update_slice would clamp the start; the port
    refuses, and sets ``pos`` on a new tensor."""
    _, cfg = _cfgs()
    _, mp = _trees(_cfgs()[0], "dense")
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="runs past"):
        T.prefill_chunk(cfg, mp, cache, torch.zeros((1, 4), dtype=torch.int32), 0, 6)
    pos = cache["pos"]
    _, new = T.prefill_chunk(cfg, mp, cache, torch.zeros((1, 4), dtype=torch.int32), 0, 0)
    assert new["pos"] is not pos and pos.tolist() == [0, 0] and new["pos"].tolist() == [4, 0]


# ---------------------------------------------------------------------------
# the fused decode + prefill step
# ---------------------------------------------------------------------------

def _mid_prefill(engine, cfg, prompts):
    """3 slots: 0 and 2 prefilled whole and decoding, 1 holding its first
    3 prompt tokens."""
    state = engine.init_decode(3, PROMPT_LEN, 4)
    state = engine.prefill_into(state, 0, prompts[0])
    state = engine.prefill_into(state, 2, prompts[2])
    return engine.prefill_chunk_into(state, 1, prompts[1][:3], 0)


@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_fused_step_matches_the_reference(engines, mode):
    cfg, jeng, eng = engines(mode)
    prompts = _prompts(cfg)
    jst, st = _mid_prefill(jeng, cfg, prompts), _mid_prefill(eng, cfg, prompts)
    np.testing.assert_allclose(_t(st.logits), _np(jst.logits), **TOL)
    tok = np.argmax(_np(jst.logits), axis=-1).astype(np.int32)
    keep = np.array([False, True, False])
    for off in (3, 6):
        c = min(3, PROMPT_LEN - off)
        jst = jeng.fused_step(jst, tok, keep, 1, prompts[1][off:off + c], off)
        st = eng.fused_step(st, tok, keep, 1, prompts[1][off:off + c], off)
        np.testing.assert_allclose(_t(st.logits), _np(jst.logits), **TOL, err_msg=f"{off}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_t(st.cache[name]), _np(jst.cache[name]), **TOL)
        assert st.cache["pos"].tolist() == np.asarray(jst.cache["pos"]).tolist()
        tok = np.argmax(_np(jst.logits), axis=-1).astype(np.int32)
    assert st.cache["pos"].tolist() == [PROMPT_LEN + 2, PROMPT_LEN, PROMPT_LEN + 2]


def test_fused_step_keeps_the_old_pos_and_overwrites_the_foreign_write(engines):
    """The two facts the in-place fused step rests on: ``decode_step``
    leaves the old ``pos`` unmodified for ``cache_keep`` to re-select, and
    its K/V write into the mid-prefill slot lands at exactly the row the
    chunk overwrites, so slot 1 ends as a chunk alone would leave it."""
    cfg, _, eng = engines("det")
    prompts = _prompts(cfg)
    st = _mid_prefill(eng, cfg, prompts)
    tok = torch.argmax(st.logits, dim=-1)
    old_pos = st.cache["pos"].clone()
    k_before = st.cache["k"].clone()
    # the decode alone: every slot's row at its pos is written, nothing else
    _, dec = T.decode_step(cfg, eng.params, {n: t.clone() for n, t in st.cache.items()},
                           tok[:, None].to(torch.int32))
    changed = (dec["k"] != k_before).any(dim=(0, 3, 4))            # (slots, rows)
    assert changed[1].nonzero().flatten().tolist() == [3]          # pos[1] = offset 3
    assert dec["pos"].tolist() == (old_pos + 1).tolist()
    # the fused step against the chunk alone
    alone = _mid_prefill(eng, cfg, prompts)
    alone = eng.prefill_chunk_into(alone, 1, prompts[1][3:6], 3)
    fused = eng.fused_step(st, tok, [False, True, False], 1, prompts[1][3:6], 3)
    assert torch.equal(old_pos, torch.tensor([PROMPT_LEN, 3, PROMPT_LEN], dtype=torch.int32))
    assert fused.cache["pos"].tolist() == [PROMPT_LEN + 1, 6, PROMPT_LEN + 1]
    for name in ("k", "v"):
        assert torch.equal(fused.cache[name][:, 1], alone.cache[name][:, 1]), name
    assert torch.equal(fused.logits[1], alone.logits[1])


# ---------------------------------------------------------------------------
# the serving matrix (the reference's TestSingleDeviceMatrix, mirrored)
# ---------------------------------------------------------------------------

class TestSingleDeviceMatrix:
    @pytest.mark.parametrize("prefill", ["whole", "chunked"])
    @pytest.mark.parametrize("plan_mode", ["dense", "det", "xnor"])
    def test_stream_matches_generate(self, engines, plan_mode, prefill):
        """{dense, det, xnor} x {whole-prompt, chunked} without a prefix
        cache: streams through mid-stream refill equal generate and the
        reference's streams."""
        cfg, jeng, eng = engines(plan_mode)
        prompts = _prompts(cfg)
        want = _oracle(eng, prompts)
        kw = {"prefill_chunk": 3} if prefill == "chunked" else {}
        assert _stream(eng, prompts, **kw) == want
        assert _j_stream(jeng, prompts, **kw) == want

    @pytest.mark.parametrize("prefill", ["whole", "chunked"])
    @pytest.mark.parametrize("plan_mode", ["dense", "det", "xnor"])
    def test_prefix_cache_miss_then_hit(self, engines, plan_mode, prefill):
        """A cold pass (misses and one mid-stream full hit from the repeated
        prompt), then a warm pass where every admission hits; both equal
        generate, and the port's cache counts what the reference's counts."""
        cfg, jeng, eng = engines(plan_mode)
        prompts = _prompts(cfg)
        want = _oracle(eng, prompts)
        chunk = 3 if prefill == "chunked" else 0
        pc, jpc = PrefixCache(), JPrefixCache()
        for _ in range(2):
            assert _stream(eng, prompts, prefill_chunk=chunk, prefix_cache=pc) == want
            assert _j_stream(jeng, prompts, prefill_chunk=chunk, prefix_cache=jpc) == want
            assert pc.stats() == jpc.stats()
        assert pc.hits >= 1 + len(MAX_NEWS) and pc.evictions == 0


def test_sliding_window_ring_wrap():
    """Chunk boundaries crossing the ring's wrap: window 6 with a 12-token
    prompt wraps the chunked writes mid-prefill, so the age masks and the
    post-attention ring write run on both sides of the seam."""
    jcfg, cfg = _cfgs("h2o_danube_3_4b", 6)
    jp, mp = _trees(jcfg, "dense")
    jeng, eng = JServeEngine(jcfg, jp), ServeEngine(cfg, mp)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    max_news = [3, 4, 2]
    want = _oracle(eng, prompts, max_news)
    kw = dict(max_news=max_news, prompt_len=12, cap=4, prefill_chunk=5)
    assert _stream(eng, prompts, **kw) == want
    assert _j_stream(jeng, prompts, **kw) == want


def test_ring_slots_waiting_mid_prefill_keep_their_position():
    """Three slots on a 6-token ring, prompts sharing their first 6 tokens:
    a partial prefix hit leaves a slot at offset 6 waiting while an older
    slot's chunks are fused into the decode steps. The decode writes into
    the waiting slot at ``pos % 6``; only ``cache_keep`` pinning its ``pos``
    keeps that write on the row its own next chunk overwrites (with ``pos``
    climbing, the write lands on rows the chunk still attends)."""
    jcfg, cfg = _cfgs("h2o_danube_3_4b", 6)
    jp, mp = _trees(jcfg, "dense")
    jeng, eng = JServeEngine(jcfg, jp), ServeEngine(cfg, mp)
    prompts = np.random.default_rng(2).integers(1, cfg.vocab_size, size=(7, 12)).astype(np.int32)
    prompts[:, :6] = prompts[0, :6]
    max_news = [4, 2, 5, 3, 4, 2, 3]
    want = _oracle(eng, prompts, max_news)
    kw = dict(n_slots=3, max_news=max_news, prompt_len=12, cap=5, prefill_chunk=3)
    pc, jpc = PrefixCache(), JPrefixCache()
    assert _stream(eng, prompts, prefix_cache=pc, **kw) == want
    assert _j_stream(jeng, prompts, prefix_cache=jpc, **kw) == want
    assert pc.stats() == jpc.stats() and pc.hits >= 1


def test_chunked_stream_traces_its_spans(engines):
    """The chunked loop's spans: prefill_chunk / decode_prefill /
    prefix_splice with their dispatch and device children, prefix_capture,
    and the serve_prefix_* metrics."""
    from repro_torch.obs import MetricsRegistry, Tracer

    cfg, _, eng = engines("det")
    tr, reg = Tracer(), MetricsRegistry()
    traced = ServeEngine(cfg, eng.params, tracer=tr)
    pc = PrefixCache()
    _stream(traced, _prompts(cfg), prefill_chunk=3, prefix_cache=pc, metrics=reg)
    spans = [e for e in tr.events if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"prefill_chunk", "decode_prefill", "prefix_splice", "prefix_capture"} <= names
    for parent in ("prefill_chunk", "decode_prefill", "prefix_splice"):
        outer = [e for e in spans if e["name"] == parent]
        kids = [e for e in spans if e["name"] in ("dispatch", "device")
                and any(e["args"]["depth"] == o["args"]["depth"] + 1
                        and o["ts"] <= e["ts"] <= o["ts"] + o["dur"] for o in outer)]
        assert len(kids) >= 2 * len(outer), parent
    assert reg["serve_prefix_hits_total"].value == pc.hits >= 1
    assert reg["serve_prefix_misses_total"].value == pc.misses
    assert reg["serve_prefix_bytes"].value == pc.nbytes
    assert reg["serve_prefill_chunks_total"].value > 0
