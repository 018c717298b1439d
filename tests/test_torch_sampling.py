"""The port's temperature sampling (``core.prng.{uniform, gumbel,
categorical}``, ``ServeEngine.generate(temperature=, key=)``,
``stream_serve(temperature=, key=)``) against the reference on the CPU.

The uniform words under ``categorical`` are the reference's bit for bit.
The Gumbel draw ``-log(-log(u))`` is not: torch's ``log`` and XLA's differ
in their last bits, and that is the only difference. Over 20 keys x 4 x
4096 draws on one x86 host the largest |gumbel difference| between torch's
CPU and XLA's CPU is 9.5e-7 (one ulp of values in [4, 8)); between an H100
and a host CPU's torch it reached 1.0e-4 (``chip_smoke.py``'s temperature
phase): for u near 1 the outer ``log`` turns the inner one's relative error
into an absolute one. ``GUMBEL_ATOL`` = 2^-10 (9.8e-4) bounds both with
room. A sampled token may then differ only where the top two of ``logits /
T + gumbel`` are within 2 x ``GUMBEL_ATOL`` of each other (the port's side;
the smallest margin met is printed, ``-s``).

Through the model, the tempered logits themselves also differ by the f32
order of sums (``TOL`` = 1e-4 on the logits, so 1e-4 / T tempered), and a
token may differ only where the margin is within ``SAMPLE_TOL`` = 2 x
(1e-4 / T + ``GUMBEL_ATOL``). Logprobs, under the tempered distribution,
hold 1e-4 / T + 1e-4 wherever the tokens agree.
"""
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
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SlotBatcher as JSlotBatcher
from repro.serve import stream_serve as j_stream_serve
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine, SlotBatcher, stream_serve
from repro_torch.serve.engine import sample_tokens, tempered

GUMBEL_ATOL = 2.0 ** -10
TEMPERATURE = 0.8
SAMPLE_TOL = 2 * (1e-4 / TEMPERATURE + GUMBEL_ATOL)
TINY = np.finfo(np.float32).tiny


def _margin(x: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(x, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


@pytest.mark.parametrize("shape", [(3, 7), (4, 4096), (2, 3, 50)])
def test_uniform_words_and_gumbel_match_jax(shape):
    for seed in range(8):
        ju = np.asarray(jax.random.uniform(jax.random.key(seed), shape, minval=TINY,
                                           maxval=1.0))
        pu = prng.uniform(prng.key(seed), shape, minval=TINY, maxval=1.0).numpy()
        assert np.array_equal(ju.view(np.int32), pu.view(np.int32)), seed
        assert pu.min() >= TINY
        jg = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
        pg = prng.gumbel(prng.key(seed), shape).numpy()
        np.testing.assert_allclose(pg, jg, rtol=0, atol=GUMBEL_ATOL)
    # the default range is the [0, 1) floats unchanged
    assert np.array_equal(prng.uniform(prng.key(1), (5,)).numpy(),
                          np.asarray(jax.random.uniform(jax.random.key(1), (5,))))


@pytest.mark.parametrize("shape,scale", [((4, 16), 1.0), ((8, 512), 3.0), ((2, 5, 33), 0.1),
                                         ((1, 49152), 2.0)])
def test_categorical_matches_jax(shape, scale):
    """Over 16 keys (2 at the vocabulary's width): equal draws except where
    the port's top-2 margin of logits + gumbel is within 2 x GUMBEL_ATOL."""
    smallest, checked = np.inf, 0
    for seed in range(16 if np.prod(shape) < 10_000 else 2):
        lg = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
        want = np.asarray(jax.random.categorical(jax.random.key(seed), jnp.asarray(lg)))
        got = prng.categorical(prng.key(seed), torch.from_numpy(lg))
        assert got.dtype == torch.int32 and tuple(got.shape) == shape[:-1]
        margin = _margin(torch.from_numpy(lg) + prng.gumbel(prng.key(seed), shape))
        clear = margin > 2 * GUMBEL_ATOL
        assert np.array_equal(got.numpy()[clear.numpy()], want[clear.numpy()]), seed
        smallest = min(smallest, float(margin.min()))
        checked += int(clear.sum())
    print(f"categorical {shape}: {checked} draws equal jax's; smallest margin {smallest:.3e}")
    assert checked > 0


def test_categorical_takes_f32_only():
    with pytest.raises(TypeError, match="f32"):
        prng.categorical(prng.key(0), torch.zeros((2, 3), dtype=torch.bfloat16))


def test_tempered_is_a_true_division():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 100)).astype(np.float32))
    got = tempered(x.to(torch.bfloat16), 0.7)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.to(torch.bfloat16).to(torch.float32) / torch.tensor(0.7))


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(mode):
        if mode not in cache:
            jcfg, cfg = (jcb.get_config("starcoder2_3b", smoke=True),
                         cb.get_config("starcoder2_3b", smoke=True))
            jp = JT.init_lm(jcfg, jax.random.key(0))
            mp = from_jax_tree(jp, device="cpu")
            if mode != "dense":
                jp = j_compile_plan(jp, J_POLICY, mode).pack(jp, key=jax.random.key(3))
                mp = compile_plan(mp, DEFAULT_POLICY, mode).pack(mp, key=prng.key(3))
            cache[mode] = (cfg, JServeEngine(jcfg, jp), ServeEngine(cfg, mp))
        return cache[mode]

    return get


def _tempered_margins(cfg, engine, prompts, tokens, key, max_new):
    """(B, max_new) top-2 margins of logits / T + gumbel along the port's
    sampled path, with the keys ``generate`` splits."""
    out = []
    lg, cache = T.prefill(cfg, engine.params, torch.from_numpy(prompts),
                          max_len=prompts.shape[1] + max_new)
    for i in range(max_new):
        key, sub = prng.split(key)
        x = tempered(lg, TEMPERATURE)
        out.append(_margin(x + prng.gumbel(sub, tuple(x.shape))))
        if i < max_new - 1:
            lg, cache = T.decode_step(cfg, engine.params, cache, tokens[:, i:i + 1])
    return torch.stack(out, 1)


@pytest.mark.parametrize("mode", ["dense", "det", "xnor"])
def test_generate_at_temperature_matches_the_reference(engines, mode):
    cfg, jeng, eng = engines(mode)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    for seed in (0, 5):
        want = jeng.generate(jnp.asarray(prompts), 6, temperature=TEMPERATURE,
                             key=jax.random.key(seed))
        got = eng.generate(prompts, 6, temperature=TEMPERATURE, key=prng.key(seed))
        wt, gt = np.asarray(want.tokens), got.tokens.numpy()
        margin = _tempered_margins(cfg, eng, prompts, got.tokens, prng.key(seed), 6)
        # rows agree up to the first step whose margin is within SAMPLE_TOL
        whole = 0
        for b in range(len(prompts)):
            diff = np.nonzero(wt[b] != gt[b])[0]
            upto = int(diff[0]) if len(diff) else 6
            if upto < 6:
                assert float(margin[b, upto]) <= SAMPLE_TOL, (mode, seed, b, upto)
            whole += upto == 6
            np.testing.assert_allclose(got.logprobs[b, :upto].numpy(),
                                       np.asarray(want.logprobs)[b, :upto],
                                       rtol=0, atol=1e-4 / TEMPERATURE + 1e-4)
        print(f"{mode} key {seed}: {whole} of {len(prompts)} rows' tempered tokens equal "
              f"the reference's; smallest margin {float(margin.min()):.3e}")
        assert whole > 0


def test_generate_logprobs_are_under_the_tempered_distribution(engines):
    cfg, _, eng = engines("det")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    got = eng.generate(prompts, 1, temperature=0.5, key=prng.key(9))
    lg, _ = T.prefill(cfg, eng.params, torch.from_numpy(prompts), max_len=9)
    want = torch.log_softmax(lg / 0.5, dim=-1).gather(-1, got.tokens.long())[:, 0]
    torch.testing.assert_close(got.logprobs[:, 0], want, rtol=1e-6, atol=1e-6)
    tok, lp = sample_tokens(lg, 0.0)
    assert torch.equal(tok, torch.argmax(lg, dim=-1).to(torch.int32))
    assert torch.equal(lp, torch.log_softmax(lg, dim=-1).gather(-1, tok[:, None].long())[:, 0])


def test_generate_key_chain_splits_once_a_token(engines):
    """Token i is drawn with ``split(key_i)[1]``, and ``key_{i+1} =
    split(key_i)[0]``: a shorter generation from the same key is a prefix
    of a longer one, and the first token is ``categorical(split(key)[1],
    logits / T)``."""
    cfg, _, eng = engines("dense")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    a = eng.generate(prompts, 4, temperature=1.0, key=prng.key(11))
    b = eng.generate(prompts, 2, temperature=1.0, key=prng.key(11))
    assert torch.equal(a.tokens[:, :2], b.tokens)
    lg, _ = T.prefill(cfg, eng.params, torch.from_numpy(prompts), max_len=12)
    sub = prng.split(prng.key(11))[1]
    assert torch.equal(a.tokens[:, 0], prng.categorical(sub, tempered(lg, 1.0)))
    with pytest.raises(ValueError, match="PRNG key"):
        eng.generate(prompts, 2, temperature=0.5)


@pytest.mark.parametrize("prefill_chunk", [0, 3])
def test_stream_serve_at_temperature_matches_the_reference(engines, prefill_chunk):
    """One split per emission step, in the plain loop and in the fused
    chunked-prefill loop alike: the port's streams equal the reference's."""
    cfg, jeng, eng = engines("det")
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, 8), int(m)) for m in (4, 2, 5, 3)]
    jb, pb = JSlotBatcher(2, 8), SlotBatcher(2, 8)
    for p, m in reqs:
        jb.submit(p, m)
        pb.submit(p, m)
    jsteps = j_stream_serve(jeng, jb, temperature=TEMPERATURE, key=jax.random.key(6),
                            prefill_chunk=prefill_chunk)
    steps = stream_serve(eng, pb, temperature=TEMPERATURE, key=prng.key(6),
                         prefill_chunk=prefill_chunk)
    assert steps == jsteps
    assert {r.uid: r.generated for r in pb.completed} == {
        r.uid: r.generated for r in jb.completed}
    with pytest.raises(ValueError, match="PRNG key"):
        stream_serve(eng, SlotBatcher(1, 8), temperature=0.5)
