"""The port's LM ensemble (``ServeEngine(ensemble=ReplicaSet)``,
``stream_serve`` over the (K, ...) cache, ``launch.serve --ensemble`` on a
token arch) against the reference on the CPU.

``stoch.sample_replicas`` packs each stacked (L, K, N) LM leaf of every
replica with the reference's keys, so the replica words are the reference's
bit for bit. The reference vmaps every replica over a K-stacked cache; the
port loops over the replicas, each on its own view of one (K, ...) cache
written in place, and condenses them with ``stoch.ensemble_stats``. At the
f32 SMOKE size the ensemble's greedy streams equal the reference's, and its
mean logits, agreement and variance hold ``TOL`` (rtol 1e-4 / atol 1e-4:
only the order of f32 sums differs). Mirrors the reference's
``TestEnsembleServing`` and ``TestEnsembleConformance`` rows: K = 1 is the
stochastic single-sample engine bit for bit, the same seed gives the same
stream, ``stream_serve`` equals one-shot ``generate``, and K >= 2 refuses
chunked prefill, the prefix cache and ``decode_steps``.
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
from repro.stoch import sample_replicas as j_sample_replicas
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve
from repro_torch.stoch import sample_replicas

ARCH = "starcoder2_3b"
TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT_LEN = 8


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def lm():
    """(jcfg, cfg, reference masters, port masters, reference plan, port plan)."""
    jcfg, cfg = jcb.get_config(ARCH, smoke=True), cb.get_config(ARCH, smoke=True)
    jp = JT.init_lm(jcfg, jax.random.key(0))
    mp = from_jax_tree(jp, device="cpu")
    return (jcfg, cfg, jp, mp, j_compile_plan(jp, J_POLICY, "stoch", warn=False),
            compile_plan(mp, DEFAULT_POLICY, "stoch"))


@pytest.fixture(scope="module")
def k2(lm):
    """(reference engine, port engine) over K = 2 replicas at key 2."""
    jcfg, cfg, jp, mp, jplan, plan = lm
    return (JServeEngine(jcfg, None, ensemble=j_sample_replicas(jp, jplan, jax.random.key(2), 2),
                         abstain_threshold=0.5),
            ServeEngine(cfg, None, ensemble=sample_replicas(mp, plan, prng.key(2), 2),
                        abstain_threshold=0.5))


def _prompts(cfg, n=3, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (n, PROMPT_LEN)).astype(np.int32)


def test_replica_words_equal_the_reference(lm, k2):
    """The K = 2 replicas of every stacked LM projection: words and scales."""
    cfg = lm[1]
    jrs, rs = k2[0]._replicas, k2[1]._replicas
    assert rs.paths == jrs.paths and len(rs.paths) == 4 and rs.k == jrs.k == 2
    for path in rs.paths:
        got, want = rs.stacked[path], jrs.stacked[path]
        assert tuple(got.packed.shape) == tuple(want.packed.shape)
        assert got.packed.shape[:2] == (2, cfg.n_layers)
        assert np.array_equal(got.packed.numpy(), np.asarray(want.packed)), path
        np.testing.assert_allclose(got.scale.numpy(), _np(want.scale), rtol=1e-6)
    assert rs.tree_nbytes() == jrs.tree_nbytes()


class TestEnsembleServing:
    def test_k1_engine_bit_identical_to_stoch_packed(self, lm):
        """K = 1 serving is the single-sample stochastic pack's, tokens and
        logprobs bit for bit."""
        _, cfg, _, mp, _, plan = lm
        plain = ServeEngine(cfg, plan.pack(mp, key=prng.key(7)))
        ens = ServeEngine(cfg, None, ensemble=sample_replicas(mp, plan, prng.key(7), 1))
        assert ens._replicas is None
        a = plain.generate(_prompts(cfg, 2), max_new=6)
        b = ens.generate(_prompts(cfg, 2), max_new=6)
        assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logprobs, b.logprobs)
        assert b.vote_agreement is None and b.logit_variance is None and b.abstained is None

    def test_same_seed_same_ensemble_stream(self, lm, k2):
        """A second draw at the fixture's key gives the same stream."""
        _, cfg, _, mp, _, plan = lm
        outs = []
        for rs in (k2[1]._replicas, sample_replicas(mp, plan, prng.key(2), 2)):
            eng = ServeEngine(cfg, None, ensemble=rs, abstain_threshold=2.0)  # all abstain
            outs.append(eng.generate(_prompts(cfg, 2), max_new=4))
        a, b = outs
        assert torch.equal(a.tokens, b.tokens)
        assert torch.equal(a.vote_agreement, b.vote_agreement)
        agr = a.vote_agreement
        assert a.tokens.shape == agr.shape == a.logit_variance.shape
        assert ((agr >= 0.0) & (agr <= 1.0)).all() and (a.logit_variance >= 0.0).all()
        assert a.abstained.all()

    def test_stream_serve_matches_generate(self, k2):
        """The loop over the resident (K, ...) cache emits the ensemble's
        one-shot generate tokens, and the uncertainty lands on the ledger."""
        _, eng = k2
        cfg = eng.cfg
        prompts = _prompts(cfg)
        want = eng.generate(prompts, max_new=4)
        batcher = SlotBatcher(n_slots=2, prompt_len=PROMPT_LEN)
        for p in prompts:
            batcher.submit(p, 4)
        stream_serve(eng, batcher)
        done = sorted(batcher.completed, key=lambda r: r.uid)
        assert len(done) == 3
        for i, r in enumerate(done):
            assert r.generated == want.tokens[i].tolist()
            assert len(r.agreement) == len(r.variance) == 4
            np.testing.assert_allclose(r.agreement, want.vote_agreement[i].numpy())
            np.testing.assert_allclose(r.variance, want.logit_variance[i].numpy(), **TOL)
            assert r.abstained == bool(want.abstained[i])


def test_k2_generate_matches_the_reference(k2):
    jeng, eng = k2
    prompts = _prompts(eng.cfg)
    want = jeng.generate(jnp.asarray(prompts), max_new=5)
    got = eng.generate(prompts, max_new=5)
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), _np(want.logprobs), **TOL)
    np.testing.assert_array_equal(got.vote_agreement.numpy(), _np(want.vote_agreement))
    np.testing.assert_allclose(got.logit_variance.numpy(), _np(want.logit_variance), **TOL)
    np.testing.assert_array_equal(got.abstained.numpy(), np.asarray(want.abstained))


def test_k2_stream_serve_matches_the_reference(k2):
    """Streams through mid-stream refill and per-token uncertainty equal the
    reference's, and so do the prefill_into / decode_step states."""
    jeng, eng = k2
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, eng.cfg.vocab_size, PROMPT_LEN), int(m)) for m in (4, 2, 5, 3)]
    jb, pb = JSlotBatcher(2, PROMPT_LEN), SlotBatcher(2, PROMPT_LEN)
    for p, m in reqs:
        jb.submit(p, m)
        pb.submit(p, m)
    assert stream_serve(eng, pb) == j_stream_serve(jeng, jb)
    want = {r.uid: r for r in jb.completed}
    for r in pb.completed:
        assert r.generated == want[r.uid].generated
        assert r.agreement == want[r.uid].agreement and r.abstained == want[r.uid].abstained
        np.testing.assert_allclose(r.variance, want[r.uid].variance, **TOL)
    jst, st = jeng.init_decode(2, PROMPT_LEN, 3), eng.init_decode(2, PROMPT_LEN, 3)
    assert st.logits.dtype == torch.float32 and st.cache["k"].shape[0] == 2
    assert tuple(st.cache["k"].shape) == tuple(jst.cache["k"].shape)
    jst = jeng.prefill_into(jst, 1, reqs[0][0])
    st = eng.prefill_into(st, 1, reqs[0][0])
    tok = np.argmax(_np(jst.logits), axis=-1).astype(np.int32)
    jst, st = jeng.decode_step(jst, tok), eng.decode_step(st, tok)
    np.testing.assert_allclose(st.logits.numpy(), _np(jst.logits), **TOL)
    np.testing.assert_allclose(st.cache["k"].numpy(), _np(jst.cache["k"]), **TOL)
    assert st.cache["pos"].tolist() == np.asarray(jst.cache["pos"]).tolist()
    np.testing.assert_array_equal(st.agreement.numpy(), _np(jst.agreement))


def test_k2_temperature_matches_the_reference(k2):
    jeng, eng = k2
    prompts = _prompts(eng.cfg, 2)
    want = jeng.generate(jnp.asarray(prompts), 4, temperature=0.8, key=jax.random.key(3))
    got = eng.generate(prompts, 4, temperature=0.8, key=prng.key(3))
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), _np(want.logprobs), rtol=0, atol=3e-4)


class TestEnsembleConformance:
    def test_k1_ensemble_chunked_prefix_stream(self, lm):
        """K = 1 is the single-sample path, so chunked prefill and prefix
        reuse hold there too."""
        _, cfg, _, mp, _, plan = lm
        eng = ServeEngine(cfg, None, ensemble=sample_replicas(mp, plan, prng.key(7), 1))
        prompts = _prompts(cfg, 5, seed=0)
        prompts[3] = prompts[0]
        max_news = [3, 5, 2, 4, 3]
        want = {i: eng.generate(p[None], m).tokens[0].tolist()
                for i, (p, m) in enumerate(zip(prompts, max_news))}
        pc = PrefixCache()
        b = SlotBatcher(2, PROMPT_LEN)
        for p, m in zip(prompts, max_news):
            b.submit(p, m)
        stream_serve(eng, b, max_new_cap=5, prefill_chunk=3, prefix_cache=pc)
        assert {r.uid: r.generated for r in b.completed} == want
        assert pc.hits >= 1

    @pytest.mark.parametrize("kw", [{"prefill_chunk": 3}, {"prefix_cache": "cache"}])
    def test_k2_ensemble_rejects_chunked_prefill(self, k2, kw):
        """K >= 2 prefills whole prompts; asking for chunks fails loudly."""
        _, eng = k2
        kw = {k: PrefixCache() if v == "cache" else v for k, v in kw.items()}
        b = SlotBatcher(2, PROMPT_LEN)
        b.submit(np.arange(PROMPT_LEN), 2)
        with pytest.raises(NotImplementedError, match="single-sample"):
            stream_serve(eng, b, **kw)

    @pytest.mark.parametrize("call", [
        lambda e, s: e.prefill_chunk_into(s, 0, [1, 2], 0),
        lambda e, s: e.fused_step(s, [0, 0], [False, True], 1, [1], 0),
        lambda e, s: e.capture_slot(s, 0),
        lambda e, s: e.splice_into(s, 0, {}),
        lambda e, s: e.decode_steps(s, 2),
    ])
    def test_k2_single_sample_entry_points_raise(self, k2, call):
        _, eng = k2
        with pytest.raises(NotImplementedError, match="single-sample"):
            call(eng, eng.init_decode(2, PROMPT_LEN, 2))

    def test_k2_decode_chunk_falls_back_to_one_step(self, k2):
        _, eng = k2
        prompts = _prompts(eng.cfg, 2)
        runs = []
        for chunk in (1, 4):
            b = SlotBatcher(2, PROMPT_LEN)
            for p in prompts:
                b.submit(p, 3)
            stream_serve(eng, b, decode_chunk=chunk)
            runs.append({r.uid: r.generated for r in b.completed})
        assert runs[0] == runs[1]


def test_engine_checks_its_ensemble_argument(lm):
    _, cfg, _, mp, _, plan = lm
    rs = sample_replicas(mp, plan, prng.key(1), 2)
    with pytest.raises(TypeError, match="ReplicaSet"):
        ServeEngine(cfg, None, ensemble=object())
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(cfg, mp, ensemble=rs)
    assert ServeEngine(cfg, rs.base, ensemble=rs).params is rs.base
