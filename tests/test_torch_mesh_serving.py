"""The port's mesh serving (``ServeEngine(mesh=, plan=)``, ``stream_serve`` on
a placed engine, ``launch.serve --mesh``) on the CPU, in one process with no
process group: StarCoder2 (smoke) on a (2, 2) and a (1, 4) ("data", "model")
mesh of CPU positions.

The reference's own mesh rows (``test_serve_conformance.py``'s forced-mesh
matrix, ``test_distributed.py``'s mesh-sharded serving) run here as the
port's: every mesh stream equals the port's single-device stream and the
reference's single-device ``generate`` or ``stream_serve`` on the same
masters (carried with ``interop.from_jax_tree``), token for token. The
reference's own forced-mesh runs are not the oracle: they need a forced
JAX device count in a subprocess.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.serve.batcher import SlotBatcher as JSlotBatcher
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.distributed import sharding as SH
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve
from repro_torch.serve.engine import MeshCache
from repro_torch.stoch import sample_replicas

ARCH = "starcoder2_3b"
TEMPERATURE = 0.8
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model"))}
_CACHE = {}


def _mesh(name="2x2"):
    shape, names = MESHES[name]
    return SH.Mesh(shape, names, device="cpu")


def _setup(mode):
    """(cfg, reference engine, port tree, plan or None), one masters draw
    carried to both sides, each side packing at the same key."""
    if mode not in _CACHE:
        jcfg, cfg = jcb.get_config(ARCH, smoke=True), cb.get_config(ARCH, smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        mp = from_jax_tree(jp, device="cpu")
        plan = None
        if mode != "dense":
            jp = j_compile_plan(jp, J_POLICY, mode, warn=False).pack(jp, key=jax.random.key(3))
            plan = compile_plan(mp, DEFAULT_POLICY, mode, warn=False)
            mp = plan.pack(mp, key=prng.key(3))
        _CACHE[mode] = (cfg, jengine.ServeEngine(jcfg, jp), mp, plan)
    return _CACHE[mode]


def _engines(mode, mesh="2x2"):
    cfg, jeng, tree, plan = _setup(mode)
    return cfg, jeng, ServeEngine(cfg, tree), ServeEngine(cfg, tree, mesh=_mesh(mesh), plan=plan)


def _requests(cfg, n_slots, max_news=(3, 5, 2, 4, 3), repeat=False, seed=0):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, size=(len(max_news), 8)).astype(np.int32)
    if repeat:      # queued behind the slots, so prompt 0's snapshot exists
        prompts[len(max_news) - 1] = prompts[0]
    return [(p, int(m)) for p, m in zip(prompts, max_news)], n_slots


def _serve(engine, reqs, **kw):
    reqs, n_slots = reqs
    b = SlotBatcher(n_slots, 8)
    for p, m in reqs:
        b.submit(p, m)
    steps = stream_serve(engine, b, **kw)
    return steps, {r.uid: list(r.generated) for r in b.completed}


def _j_generate(jeng, reqs):
    return {i: np.asarray(jeng.generate(jnp.asarray(p)[None], m).tokens)[0].tolist()
            for i, (p, m) in enumerate(reqs[0])}


# ---------------------------------------------------------------------------
# the reference's mesh rows, as the port's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_stream_serve_bit_identical_and_placed(mode):
    """det and xnor plans on the 2x2 mesh: greedy ``stream_serve`` through
    a mid-stream refill (5 requests, 2 slots, mixed max_new) equals the
    single-device engine and the reference's generate; packed words shard
    over "model" on the out-channel dim, and the decode cache splits its
    slots over "data" (a pure tensor-parallel mesh keeps them whole)."""
    cfg, jeng, single, eng = _engines(mode)
    reqs = _requests(cfg, 2)
    assert _serve(eng, reqs) == _serve(single, reqs)
    assert _serve(eng, reqs)[1] == _j_generate(jeng, reqs)
    w = eng.params["layers"]["attn"]["w_qkv"]
    assert w.spec == (None, None, "model")
    assert w.local.flat[0].packed.shape[-1] * 2 == w.master_shape[-1]
    state = eng.init_decode(2, 8, 4)
    assert isinstance(state.cache, MeshCache) and len(state.cache.parts) == 2
    assert state.cache.parts[0]["k"].shape[1] == 1 and state.cache["k"].shape[1] == 2
    assert state.cache["pos"].tolist() == [0, 0]
    tp = ServeEngine(cfg, _setup(mode)[2], mesh=SH.Mesh((4,), ("model",), device="cpu"))
    tp_state = tp.init_decode(2, 8, 4)
    assert len(tp_state.cache.parts) == 1 and tp_state.cache.per == 2


@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_chunked_decode_bit_identical_sharded(mode):
    """``decode_chunk=3`` (three decode steps a call, one host read) on the
    2x2 mesh gives the single-step single-device streams and step count."""
    cfg, _, single, eng = _engines(mode)
    reqs = _requests(cfg, 2)
    assert _serve(eng, reqs, decode_chunk=3) == _serve(single, reqs)


@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_sharded_chunked_prefix_stream(mode):
    """Chunked prefill (chunks of 3) with the prefix cache on the 2x2 mesh,
    4 slots: request 4 repeats prompt 0 behind the slots, a mid-stream
    prefix hit; every stream equals the reference's one-shot generate."""
    cfg, jeng, _, eng = _engines(mode)
    reqs = _requests(cfg, 4, repeat=True)
    pc = PrefixCache()
    _, got = _serve(eng, reqs, max_new_cap=5, prefill_chunk=3, prefix_cache=pc)
    assert got == _j_generate(jeng, reqs)
    assert pc.hits >= 1


def test_sharded_whole_prompt_stream_dense():
    """A dense master tree on the 2x2 mesh (placed by the path rules: the
    row projections' f32 partials summed), whole-prompt admission: every
    stream equals the reference's one-shot generate."""
    cfg, jeng, _, eng = _engines("dense")
    reqs = _requests(cfg, 4)
    _, got = _serve(eng, reqs, max_new_cap=5)
    assert got == _j_generate(jeng, reqs)


# ---------------------------------------------------------------------------
# beyond the mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_mesh_streams_equal_single_device_and_the_reference(mesh, mode):
    """Whole-prompt and chunked + prefix admission on each mesh equal the
    single-device streams, and the whole-prompt ones the reference's
    ``stream_serve`` on 2 slots."""
    cfg, jeng, single, eng = _engines(mode, mesh)
    reqs = _requests(cfg, 2, max_news=(4, 2, 5, 3, 4), repeat=True, seed=4)
    got = _serve(eng, reqs)
    assert got == _serve(single, reqs)
    jb = JSlotBatcher(2, 8)
    for p, m in reqs[0]:
        jb.submit(p, m)
    jsteps = jengine.stream_serve(jeng, jb)
    assert got == (jsteps, {r.uid: list(map(int, r.generated)) for r in jb.completed})
    kw = dict(prefill_chunk=3, prefix_cache=PrefixCache())
    assert _serve(eng, reqs, **kw) == _serve(single, reqs, prefill_chunk=3,
                                              prefix_cache=PrefixCache())


@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_tempered_mesh_streams_equal_single_device_and_the_reference(mode):
    """Temperature sampling on the 2x2 mesh: the groups' logits rows come
    back to one host loop, so one split a step draws the single-device
    tokens, which equal the reference's."""
    cfg, jeng, single, eng = _engines(mode)
    reqs = _requests(cfg, 2, max_news=(4, 2, 5, 3), seed=4)
    got = _serve(eng, reqs, temperature=TEMPERATURE, key=prng.key(6))
    assert got == _serve(single, reqs, temperature=TEMPERATURE, key=prng.key(6))
    jb = JSlotBatcher(2, 8)
    for p, m in reqs[0]:
        jb.submit(p, m)
    jsteps = jengine.stream_serve(jeng, jb, temperature=TEMPERATURE, key=jax.random.key(6))
    assert got == (jsteps, {r.uid: list(map(int, r.generated)) for r in jb.completed})
    prompts = np.stack([p for p, _ in reqs[0]])
    a = eng.generate(prompts, 3, temperature=TEMPERATURE, key=prng.key(2))
    b = single.generate(prompts, 3, temperature=TEMPERATURE, key=prng.key(2))
    assert torch.equal(a.tokens, b.tokens)


@pytest.mark.parametrize("rows", [4, 3])
def test_generate_on_the_mesh_equals_single_device(rows):
    """One-shot ``generate``: 4 rows split over the 2 data groups; 3 rows
    do not divide, so group 0 serves them all (the reference's sanitized
    slot spec replicates them)."""
    cfg, _, single, eng = _engines("det")
    prompts = np.random.default_rng(rows).integers(0, cfg.vocab_size, (rows, 8))
    a, b = eng.generate(prompts, 4), single.generate(prompts, 4)
    assert torch.equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.logprobs, b.logprobs, rtol=0, atol=1e-5)
    _, cache = eng._prefill(torch.from_numpy(prompts.astype(np.int32)), 10)
    assert len(cache.parts) == (2 if rows == 4 else 1)


def _refused(what):
    cfg = cb.get_config({"moe": "moonshot_v1_16b_a3b", "ssm": "mamba2_130m",
                         "hybrid": "jamba_1_5_large"}.get(what, ARCH), smoke=True)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    if what == "ensemble":
        plan = compile_plan(params, DEFAULT_POLICY, "stoch", warn=False)
        rs = sample_replicas(params, plan, prng.key(1), 2)
        return lambda: ServeEngine(cfg, None, ensemble=rs, mesh=_mesh())
    return lambda: ServeEngine(cfg, params, mesh=_mesh())


@pytest.mark.parametrize("what", ["ensemble", "moe", "ssm", "hybrid"])
def test_mesh_refusals_name_item_7b(what):
    """An ensemble's replica placement, and the MoE, SSM and hybrid families
    on a mesh, wait for ROADMAP item 7b (an MoE layer's capacity follows
    the tokens of a call, so a data split would change it)."""
    with pytest.raises(NotImplementedError, match="item 7b"):
        _refused(what)()


def test_plan_without_a_mesh_raises():
    cfg, _, tree, plan = _setup("det")
    with pytest.raises(ValueError, match="only places params on a mesh"):
        ServeEngine(cfg, tree, plan=plan)
    with pytest.raises(ValueError, match="serving mesh"):
        ServeEngine(cfg, tree, mesh=SH.Mesh((2, 2), ("x", "model"), device="cpu"))


LM_SMOKE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
            "--prompt-len", "8", "--max-new", "3"]


def test_cli_serves_on_a_mesh(capsys):
    """``--mesh data,model --mesh-shape 2,2`` serves (xnor, packed) with the
    mesh and the placed bytes printed, its streams the single-device
    CLI's; the classifier and a bare ``--mesh-shape`` exit with the
    reference's messages, an ensemble or an SSM arch on a mesh naming
    item 7b."""
    mesh_args = ["--mesh", "data,model", "--mesh-shape", "2,2"]
    res = serve.main(LM_SMOKE + ["--packed", "--binarize", "xnor"] + mesh_args)
    out = capsys.readouterr().out
    assert "mesh: {'data': 2, 'model': 2} over 4 positions on cpu" in out
    assert "placed on the mesh:" in out
    assert res.engine.mesh is not None and len(res.batcher.completed) == 5
    one = serve.main(LM_SMOKE + ["--packed", "--binarize", "xnor"])
    assert ({r.uid: r.generated for r in res.batcher.completed}
            == {r.uid: r.generated for r in one.batcher.completed})
    with pytest.raises(SystemExit, match="classifier path is fixed-batch single-device"):
        serve.main(["--arch", "mnist_fc", "--device", "cpu", "--smoke"] + mesh_args)
    with pytest.raises(SystemExit, match="--mesh-shape requires --mesh"):
        serve.main(LM_SMOKE + ["--mesh-shape", "2,2"])
    with pytest.raises(SystemExit, match="item 7b"):
        serve.main(LM_SMOKE + ["--packed", "--binarize", "stoch", "--ensemble", "2"]
                   + mesh_args)
    with pytest.raises(SystemExit, match="item 7b"):
        serve.main(["--arch", "mamba2_130m", "--smoke", "--device", "cpu"] + mesh_args)
