"""Serving the SSM family (``serve.engine`` and ``launch.serve``'s token path
on mamba2-130m's SMOKE config) against the reference on the CPU.

The same masters (the reference's ``init_lm`` at key 0, carried with
``interop.from_jax_tree``), packed by each side at the same key, serve the
same prompts on 2 slots. Mirrors the reference's mamba2 rows of
``tests/test_serving.py`` (``prefill_into`` against a batched prefill, the
greedy stream against one-shot ``generate``, ``decode_chunk`` streams) and
``tests/test_serve_conformance.py`` (the chunked-prefill stream with a
prefix cache), and holds the port's greedy streams, whole-prompt and
chunked, equal to the reference's in det, stoch and xnor; the tempered
stream and the K = 2 ensemble's stream too. The slot's recurrent state is
what the fused decode + chunk step must keep for a mid-prefill slot.
"""
import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import transformer as JT
from repro.serve.batcher import SlotBatcher as JSlotBatcher
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import stream_serve as j_stream_serve
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro.stoch import sample_replicas as j_sample_replicas
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.layers import PackedLinear, XnorLinear
from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve
from repro_torch.stoch import sample_replicas

ARCH = "mamba2_130m"
PACK_SEED = 3
MAX_NEWS = [4, 2, 5, 3]
PROMPT_LEN = 8


@pytest.fixture(scope="module")
def engines():
    """(cfg, reference engine, port engine) per mode, built once."""
    cache = {}

    def get(mode):
        if mode not in cache:
            jcfg, cfg = jcb.get_config(ARCH, smoke=True), cb.get_config(ARCH, smoke=True)
            jp = JT.init_lm(jcfg, jax.random.key(0))
            mp = from_jax_tree(jp, device="cpu")
            if mode != "dense":
                jp = j_compile_plan(jp, J_POLICY, mode).pack(jp, key=jax.random.key(PACK_SEED))
                mp = compile_plan(mp, DEFAULT_POLICY, mode).pack(mp, key=prng.key(PACK_SEED))
            cache[mode] = (cfg, JServeEngine(jcfg, jp), ServeEngine(cfg, mp))
        return cache[mode]

    return get


def _prompts(cfg):
    prompts = np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(len(MAX_NEWS), PROMPT_LEN)).astype(np.int32)
    prompts[3, :5] = prompts[0, :5]       # a shared 5-token prefix: a prefix-cache hit
    return prompts


def _stream(engine, prompts, *, batcher=SlotBatcher, serve_fn=stream_serve,
            max_news=MAX_NEWS, **kw):
    b = batcher(2, PROMPT_LEN)
    for p, m in zip(prompts, max_news):
        b.submit(p, m)
    steps = serve_fn(engine, b, max_new_cap=max(max_news), **kw)
    assert b.idle and len(b.completed) == len(max_news)
    return steps, {r.uid: list(r.generated) for r in b.completed}


def _oracle(engine, prompts, max_news=MAX_NEWS):
    return {i: engine.generate(p[None], m).tokens[0].tolist()
            for i, (p, m) in enumerate(zip(prompts, max_news))}


# ---------------------------------------------------------------------------
# the engine's continuous batching, within the port
# ---------------------------------------------------------------------------

def test_prefill_into_matches_batched_prefill(engines):
    """init_decode + per-slot prefill_into builds exactly the cache and
    first-token logits a batched prefill would (the reference's row)."""
    cfg, _, eng = engines("dense")
    prompts = torch.from_numpy(_prompts(cfg)[:3])
    lg, cache = T.prefill(cfg, eng.params, prompts, max_len=PROMPT_LEN + 4)
    state = eng.init_decode(3, PROMPT_LEN, 4)
    for s in (2, 0, 1):   # out of order: the slot index is data
        state = eng.prefill_into(state, s, prompts[s].numpy())
    assert torch.equal(state.logits, lg)
    assert set(state.cache) == set(cache) == {"pos", "ssm", "conv"}
    for k in cache:
        assert torch.equal(state.cache[k], cache[k]), k


def test_greedy_stream_bit_identical_to_one_shot(engines):
    """Through mid-stream slot refill (5 requests, 2 slots) and mixed
    per-request max_new, in exactly ceil(sum / slots) emission steps."""
    cfg, _, eng = engines("dense")
    rng = np.random.default_rng(0)
    max_news = [3, 5, 2, 4, 3]
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN) for _ in max_news]
    steps, got = _stream(eng, prompts, max_news=max_news)
    assert steps == -(-sum(max_news) // 2)
    assert got == _oracle(eng, prompts, max_news)


def test_decode_chunk_streams_equal_the_one_token_loop(engines):
    cfg, _, eng = engines("dense")
    prompts = _prompts(cfg)
    base = _stream(eng, prompts)
    for chunk in (3, 64):   # a mid-request boundary; a chunk past the whole budget
        assert _stream(eng, prompts, decode_chunk=chunk) == base, f"decode_chunk={chunk}"


def test_fused_step_keeps_a_mid_prefill_slots_state(engines):
    """The fused step's decode advances every slot's state, so the
    mid-prefill slot's ``ssm`` and ``conv`` rows must be the ones its last
    chunk left when the next chunk runs: the slot ends where a whole-prompt
    prefill ends."""
    cfg, _, eng = engines("det")
    prompts = _prompts(cfg)
    state = eng.init_decode(3, PROMPT_LEN, 4)
    state = eng.prefill_into(state, 0, prompts[0])
    state = eng.prefill_into(state, 2, prompts[2])
    state = eng.prefill_chunk_into(state, 1, prompts[1][:3], 0)
    before = {k: state.cache[k].clone() for k in ("ssm", "conv")}
    tok = torch.argmax(state.logits, dim=-1).to(torch.int32)
    keep = np.array([False, True, False])
    state = eng.fused_step(state, tok, keep, 1, prompts[1][3:6], 3)
    for k in ("ssm", "conv"):        # the decoding slot did advance
        assert not torch.equal(state.cache[k][:, 0], before[k][:, 0]), k
    state = eng.fused_step(state, tok, keep, 1, prompts[1][6:], 6)
    lg, one = T.prefill(cfg, eng.params, torch.from_numpy(prompts[1][None]))
    np.testing.assert_allclose(state.logits[1].numpy(), lg[0].numpy(), rtol=1e-4, atol=1e-4)
    for k in ("ssm", "conv"):        # chunks against the whole prompt: f32 sum order only
        np.testing.assert_allclose(state.cache[k][:, 1:2].numpy(), one[k].numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert state.cache["pos"].tolist() == [PROMPT_LEN + 2, PROMPT_LEN, PROMPT_LEN + 2]


# ---------------------------------------------------------------------------
# the port's streams against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefill", ["whole", "chunked"])
@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_greedy_streams_equal_the_reference(engines, mode, prefill):
    """Whole-prompt, or chunks of 3 with a prefix cache (the conformance
    row: at least one hit): the streams and the cache's counts equal the
    reference's, and every stream equals the port's one-shot generate."""
    cfg, jeng, eng = engines(mode)
    prompts = _prompts(cfg)
    kw, jkw = {}, {}
    if prefill == "chunked":
        kw = dict(prefill_chunk=3, prefix_cache=PrefixCache())
        jkw = dict(prefill_chunk=3, prefix_cache=JPrefixCache())
    steps, got = _stream(eng, prompts, **kw)
    jsteps, want = _stream(jeng, prompts, batcher=JSlotBatcher, serve_fn=j_stream_serve, **jkw)
    assert got == want and steps == jsteps
    if prefill == "chunked":
        assert kw["prefix_cache"].stats() == jkw["prefix_cache"].stats()
        assert kw["prefix_cache"].hits >= 1
    assert got == _oracle(eng, prompts)


def test_dense_chunked_prefix_stream_equals_generate(engines):
    """The reference's ``test_chunked_prefix_stream_per_family[mamba2_130m]``
    row: dense masters, chunks of 3, a prefix cache."""
    cfg, _, eng = engines("dense")
    prompts = _prompts(cfg)
    pc = PrefixCache()
    _, got = _stream(eng, prompts, prefill_chunk=3, prefix_cache=pc)
    assert got == _oracle(eng, prompts) and pc.hits >= 1


def test_stream_serve_at_temperature_matches_the_reference(engines):
    cfg, jeng, eng = engines("det")
    prompts = _prompts(cfg)
    steps, got = _stream(eng, prompts, temperature=0.7, key=prng.key(6))
    jsteps, want = _stream(jeng, prompts, batcher=JSlotBatcher, serve_fn=j_stream_serve,
                           temperature=0.7, key=jax.random.key(6))
    assert got == want and steps == jsteps


def test_k2_ensemble_stream_matches_the_reference():
    """K = 2 stochastic replicas over the (K, ...) state cache: the streams
    and vote agreements equal the reference's and the port's own generate."""
    jcfg, cfg = jcb.get_config(ARCH, smoke=True), cb.get_config(ARCH, smoke=True)
    jp = JT.init_lm(jcfg, jax.random.key(0))
    mp = from_jax_tree(jp, device="cpu")
    jrs = j_sample_replicas(jp, j_compile_plan(jp, J_POLICY, "stoch", warn=False),
                            jax.random.key(2), 2)
    rs = sample_replicas(mp, compile_plan(mp, DEFAULT_POLICY, "stoch"), prng.key(2), 2)
    jeng, eng = JServeEngine(jcfg, None, ensemble=jrs), ServeEngine(cfg, None, ensemble=rs)
    prompts = _prompts(cfg)
    jb, pb = JSlotBatcher(2, PROMPT_LEN), SlotBatcher(2, PROMPT_LEN)
    for p, m in zip(prompts, MAX_NEWS):
        jb.submit(p, m)
        pb.submit(p, m)
    assert stream_serve(eng, pb) == j_stream_serve(jeng, jb)
    want = {r.uid: r for r in jb.completed}
    for r in pb.completed:
        assert r.generated == want[r.uid].generated
        assert r.agreement == want[r.uid].agreement
    assert {r.uid: r.generated for r in pb.completed} == _oracle(eng, prompts)
    st = eng.init_decode(2, PROMPT_LEN, 3)
    assert st.cache["ssm"].shape[0] == 2 and st.cache["conv"].shape[0] == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SSM_SMOKE = ["--arch", "mamba2_130m", "--smoke", "--device", "cpu", "--requests", "3",
             "--slots", "2", "--prompt-len", "6", "--max-new", "2"]


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_cli_serves_the_ssm_arch(mode, capsys):
    res = serve.main(SSM_SMOKE + ["--packed", "--binarize", mode])
    out = capsys.readouterr().out
    assert "packed weights: " in out and "served 3 requests in" in out
    leaf = res.engine.params["layers"]["ssm"]["in_proj"]
    assert type(leaf) is (XnorLinear if mode == "xnor" else PackedLinear)
    assert leaf.packed.shape[0] == res.cfg.n_layers
    assert isinstance(res.engine.params["layers"]["ssm"]["conv"], torch.Tensor)
    assert res.tokens == sum(len(r.generated) for r in res.batcher.completed) == 6


@pytest.mark.parametrize("argv,flag", [
    (["--packed"], "packed weights: "),
    (["--packed", "--prefill-chunk", "4", "--prefix-cache", "8", "--shared-prefix", "4"],
     "prefix cache: "),
])
def test_cli_summary_lines_equal_the_reference(argv, flag, capsys, monkeypatch):
    """The bytes line and the prefix cache's counts depend on the shapes and
    prompts only, so the lines equal the reference's."""
    from repro.launch import serve as jserve

    serve.main(SSM_SMOKE + argv)
    mine = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(flag)]
    monkeypatch.setattr("sys.argv", ["serve"] + argv + [
        a for a in SSM_SMOKE if a not in ("--device", "cpu")])
    jserve.main()
    ref = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(flag)]
    assert mine == ref and len(mine) == 1
