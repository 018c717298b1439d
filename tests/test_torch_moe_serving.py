"""Serving the MoE family (``serve.engine``, ``launch.serve``'s token path)
against the reference on the CPU.

The same masters (the reference's ``init_lm`` at key 0, carried with
``interop.from_jax_tree``), packed by each side at the same key, serve
the same prompts on 2 slots: the port's greedy streams, whole-prompt and
chunked, with a prefix cache, equal the reference's ``ServeEngine``
streams and the port's own one-shot ``generate``. The CLI serves both MoE
archs (det, stoch, chunked with a prefix cache, the K = 2 ensemble), and
``--binarize xnor`` on an MoE arch exits naming the reference's gap.
"""
import jax
import numpy as np
import pytest

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import transformer as JT
from repro.serve.batcher import SlotBatcher as JSlotBatcher
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import stream_serve as j_stream_serve
from repro.serve.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models.layers import PackedLinear
from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve

PACK_SEED = 3
MAX_NEWS = [4, 2, 5, 3]
PROMPT_LEN = 8


@pytest.fixture(scope="module")
def engines():
    """(cfg, reference engine, port engine) per (arch, mode), built once."""
    cache = {}

    def get(arch, mode):
        if (arch, mode) not in cache:
            jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
            jp = JT.init_lm(jcfg, jax.random.key(0))
            mp = from_jax_tree(jp, device="cpu")
            if mode != "dense":
                jp = j_compile_plan(jp, J_POLICY, mode).pack(jp, key=jax.random.key(PACK_SEED))
                mp = compile_plan(mp, DEFAULT_POLICY, mode).pack(mp, key=prng.key(PACK_SEED))
            cache[arch, mode] = (cfg, JServeEngine(jcfg, jp), ServeEngine(cfg, mp))
        return cache[arch, mode]

    return get


def _prompts(cfg):
    prompts = np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(len(MAX_NEWS), PROMPT_LEN)).astype(np.int32)
    prompts[3, :5] = prompts[0, :5]       # a shared 5-token prefix: a prefix-cache hit
    return prompts


def _stream(engine, prompts, *, batcher=SlotBatcher, serve_fn=stream_serve, **kw):
    b = batcher(2, PROMPT_LEN)
    for p, m in zip(prompts, MAX_NEWS):
        b.submit(p, m)
    steps = serve_fn(engine, b, max_new_cap=max(MAX_NEWS), **kw)
    assert b.idle and len(b.completed) == len(MAX_NEWS)
    return steps, {r.uid: list(r.generated) for r in b.completed}


@pytest.mark.parametrize("prefill", ["whole", "chunked"])
@pytest.mark.parametrize("arch,mode", [("moonshot_v1_16b_a3b", "det"),
                                       ("grok_1_314b", "stoch")])
def test_greedy_streams_equal_the_reference(engines, arch, mode, prefill):
    cfg, jeng, eng = engines(arch, mode)
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
    for i, (p, m) in enumerate(zip(prompts, MAX_NEWS)):
        assert eng.generate(p[None], m).tokens[0].tolist() == got[i], f"request {i}"


MOE_SMOKE = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
             "--prompt-len", "6", "--max-new", "2"]


@pytest.mark.parametrize("arch,mode", [("moonshot_v1_16b_a3b", "det"),
                                       ("grok_1_314b", "stoch")])
def test_cli_serves_an_moe_arch(arch, mode, capsys):
    res = serve.main(["--arch", arch, "--packed", "--binarize", mode] + MOE_SMOKE)
    out = capsys.readouterr().out
    assert "packed weights: " in out and "served 3 requests in" in out
    experts = res.engine.params["layers"]["moe"]
    leaf = experts["w_up" if "w_up" in experts else "wi"]
    assert type(leaf) is PackedLinear
    assert leaf.packed.shape[:2] == (res.cfg.n_layers, res.cfg.n_experts)
    assert res.tokens == sum(len(r.generated) for r in res.batcher.completed) == 6


def test_cli_serves_an_moe_arch_chunked_and_as_an_ensemble(capsys):
    arch = ["--arch", "moonshot_v1_16b_a3b"]
    res = serve.main(arch + MOE_SMOKE + ["--packed", "--prefill-chunk", "4",
                                         "--prefix-cache", "8", "--shared-prefix", "4"])
    assert "prefix cache: " in capsys.readouterr().out and res.prefix_cache.hits >= 1
    for r in res.batcher.completed:
        assert res.engine.generate(r.prompt[None], r.max_new).tokens[0].tolist() == r.generated
    res = serve.main(arch + MOE_SMOKE + ["--packed", "--binarize", "stoch", "--ensemble", "2"])
    assert "ensemble K=2 (stoch): " in capsys.readouterr().out and res.replicas.k == 2


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "grok_1_314b"])
def test_cli_xnor_on_an_moe_arch_exits_naming_the_reference_gap(arch, tmp_path):
    with pytest.raises(SystemExit, match=r"src/repro/models/moe.py:22-34\) takes no XnorLinear"):
        serve.main(["--arch", arch, "--packed", "--binarize", "xnor"] + MOE_SMOKE)
    # a saved xnor manifest is refused too; the dry plan itself is fine
    plan = str(tmp_path / "xnor.json")
    serve.main(["--arch", arch, "--binarize", "xnor", "--plan", plan] + MOE_SMOKE)
    with pytest.raises(SystemExit, match="takes no XnorLinear"):
        serve.main(["--arch", arch, "--packed", "--plan-from", plan] + MOE_SMOKE)
