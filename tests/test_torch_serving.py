"""The port's serving layer (``serve.{engine, batcher}``, ``launch.serve``'s
token path) against the reference on the CPU.

Mirrors the reference's ``tests/test_serving.py`` on the port: the
continuous-decode rows with whole-prompt admission (``prefill_into`` builds
the batched prefill's cache, greedy streams equal one-shot ``generate``
through mid-stream refill, ``decode_chunk`` changes nothing), the slot
batcher and its ledger (hypothesis properties included), the accounting
regressions and the packed-bytes report. Beyond the mirror, the port's
greedy ``stream_serve`` streams equal the reference's on the same prompts
and weights (carried with ``interop.from_jax_tree``), each test printing
the smallest top-2 logit margin it met (``-s``), so a near tie shows; the
CLI serves a token arch on the CPU, chunked prefill, the prefix cache and
the LM ensemble included; and every feature still deferred raises naming
ROADMAP (a mesh serves; an ensemble or MoE arch on it waits for item 7b).
"""
import json

import jax
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
from repro_torch.core.policy import DEFAULT_POLICY, make_paper_policy
from repro_torch.distributed.sharding import Mesh
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.interop import from_jax_tree
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.layers import XnorConv, XnorLinear
from repro_torch.serve import ServeEngine, SlotBatcher, packed_param_bytes, stream_serve


def _engine(arch="starcoder2_3b", **kw):
    cfg = cb.get_config(arch, smoke=True)
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, ServeEngine(cfg, params, **kw)


def _margin(logits: torch.Tensor) -> float:
    top2 = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class TestServeEngine:
    def test_greedy_generation_matches_stepwise_forward(self):
        cfg, params, engine = _engine()
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32))
        out = engine.generate(prompts, max_new=4)
        assert out.tokens.shape == (2, 4) and out.tokens.dtype == torch.int32
        seq = prompts
        for i in range(4):
            logits, _ = T.forward(cfg, params, seq)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            assert torch.equal(nxt, out.tokens[:, i])
            lp = torch.log_softmax(logits[:, -1], dim=-1).gather(-1, nxt[:, None].long())[:, 0]
            torch.testing.assert_close(out.logprobs[:, i], lp, rtol=2e-3, atol=2e-3)
            seq = torch.cat([seq, nxt[:, None]], dim=1)

    def test_deferred_engine_options_raise(self):
        cfg, params, engine = _engine()
        # a mesh, once refused, serves the dense family: generate on a 2x2
        # CPU mesh equals the single-device engine; the MoE family on a
        # mesh still waits (ROADMAP item 7b)
        mesh = Mesh((2, 2), ("data", "model"), device="cpu")
        prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))
        assert torch.equal(ServeEngine(cfg, params, mesh=mesh).generate(prompts, 3).tokens,
                           engine.generate(prompts, 3).tokens)
        moe = cb.get_config("moonshot_v1_16b_a3b", smoke=True)
        with pytest.raises(NotImplementedError, match="item 7"):
            ServeEngine(moe, T.init_lm(moe, torch.Generator().manual_seed(0), device="cpu"),
                        mesh=mesh)
        # a frontend config, once refused, is served as the reference's
        # engine serves it: its backbone on token prompts
        vlm = cb.get_config("internvl2_76b", smoke=True)
        vlm_engine = ServeEngine(vlm, T.init_lm(vlm, torch.Generator().manual_seed(0),
                                                device="cpu"))
        assert vlm_engine.generate(torch.zeros((1, 3), dtype=torch.int32),
                                   max_new=2).tokens.shape == (1, 2)
        with pytest.raises(NotImplementedError, match="item 8"):
            stream_serve(engine, SlotBatcher(1, 4), sentinel=object())


class TestContinuousDecode:
    """Step-level continuous batching: the persistent slot-addressed cache
    must reproduce one-shot generation bit for bit."""

    def test_prefill_into_matches_batched_prefill(self):
        cfg, params, engine = _engine()
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (3, 8)).astype(np.int32))
        lg, cache = T.prefill(cfg, params, prompts, max_len=8 + 4)
        state = engine.init_decode(3, 8, 4)
        for s in (2, 0, 1):   # out of order: the slot index is data
            state = engine.prefill_into(state, s, prompts[s].numpy())
        assert torch.equal(state.logits, lg)
        for k in cache:
            assert torch.equal(state.cache[k], cache[k]), k

    @pytest.mark.parametrize("arch", ["starcoder2_3b", "h2o_danube_3_4b"])
    def test_greedy_stream_bit_identical_to_one_shot(self, arch):
        cfg, params, engine = _engine(arch)
        rng = np.random.default_rng(0)
        max_news = [3, 5, 2, 4, 3]
        prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in max_news]
        batcher = SlotBatcher(n_slots=2, prompt_len=8)
        for p, m in zip(prompts, max_news):
            batcher.submit(p, m)
        steps = stream_serve(engine, batcher)
        assert len(batcher.completed) == 5 and batcher.idle
        assert steps == -(-sum(max_news) // 2)
        by_uid = {r.uid: r for r in batcher.completed}
        for uid, (p, m) in enumerate(zip(prompts, max_news)):
            assert len(by_uid[uid].generated) == m
            one = engine.generate(p[None].astype(np.int32), m)
            assert by_uid[uid].generated == one.tokens[0].tolist(), f"request {uid}"

    def test_chunked_stream_bit_identical(self):
        cfg, _, engine = _engine()

        def run(chunk):
            rng = np.random.default_rng(0)
            b = SlotBatcher(n_slots=2, prompt_len=8)
            for m in [3, 5, 2, 4, 3]:
                b.submit(rng.integers(0, cfg.vocab_size, 8), m)
            steps = stream_serve(engine, b, decode_chunk=chunk)
            return steps, {r.uid: list(r.generated) for r in b.completed}

        base = run(1)
        for chunk in (3, 64):
            assert run(chunk) == base, f"decode_chunk={chunk}"

    def test_decode_steps_advance_the_state(self):
        cfg, _, engine = _engine()
        rng = np.random.default_rng(0)
        state = engine.init_decode(2, 8, 8)
        for s in (0, 1):
            state = engine.prefill_into(state, s, rng.integers(0, cfg.vocab_size, 8))
        state, toks = engine.decode_steps(state, 4)
        assert toks.shape == (2, 4) and toks.dtype == torch.int32
        assert state.cache["pos"].tolist() == [8 + 4, 8 + 4]

    def test_request_timing_ledger(self):
        cfg, _, engine = _engine()
        batcher = SlotBatcher(n_slots=2, prompt_len=4)
        rng = np.random.default_rng(0)
        for _ in range(3):
            batcher.submit(rng.integers(0, cfg.vocab_size, 4), 2)
        stream_serve(engine, batcher)
        for r in batcher.completed:
            assert r.ttft is not None and r.ttft >= 0
            assert r.latency is not None and r.latency >= r.ttft

    def test_oversized_max_new_raises(self):
        _, _, engine = _engine()
        batcher = SlotBatcher(n_slots=1, prompt_len=4)
        batcher.submit(np.arange(4), max_new=9)
        with pytest.raises(ValueError, match="max_new_cap"):
            stream_serve(engine, batcher, max_new_cap=4)


# ---------------------------------------------------------------------------
# the port's streams against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [
    ("starcoder2_3b", "dense"), ("starcoder2_3b", "det"), ("starcoder2_3b", "stoch"),
    ("starcoder2_3b", "xnor"), ("qwen2_5_32b", "det"), ("h2o_danube_3_4b", "xnor"),
    ("deepseek_coder_33b", "stoch"),
])
def test_greedy_streams_equal_the_reference(arch, mode):
    """The same masters, packed by each side at the same key, serve the
    same 6 prompts on 2 slots: every stream equals the reference's."""
    jcfg, cfg = jcb.get_config(arch, smoke=True), cb.get_config(arch, smoke=True)
    jp = JT.init_lm(jcfg, jax.random.key(0))
    mp = from_jax_tree(jp, device="cpu")
    if mode != "dense":
        jp = j_compile_plan(jp, J_POLICY, mode).pack(jp, key=jax.random.key(3))
        mp = compile_plan(mp, DEFAULT_POLICY, mode).pack(mp, key=prng.key(3))
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, 8), int(m)) for m in (4, 2, 5, 3, 4, 1)]
    jb, pb = JSlotBatcher(2, 8), SlotBatcher(2, 8)
    for p, m in reqs:
        jb.submit(p, m)
        pb.submit(p, m)
    jsteps = jengine.stream_serve(jengine.ServeEngine(jcfg, jp), jb)
    steps = stream_serve(ServeEngine(cfg, mp), pb)
    assert steps == jsteps
    want = {r.uid: r.generated for r in jb.completed}
    assert {r.uid: r.generated for r in pb.completed} == want
    # the margins the equality rode on: each request's greedy logits
    margin = np.inf
    for p, m in reqs:
        lg, cache = T.prefill(cfg, mp, torch.from_numpy(p[None].astype(np.int32)),
                              max_len=8 + m)
        for _ in range(m):
            margin = min(margin, _margin(lg))
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            lg, cache = T.decode_step(cfg, mp, cache, tok[:, None])
    print(f"{arch} {mode}: streams equal the reference's; smallest top-2 logit margin "
          f"{margin:.3e}")
    assert margin > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

LM_SMOKE = ["--arch", "starcoder2_3b", "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--prompt-len", "4", "--max-new", "2"]


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
def test_cli_serves_a_token_arch(mode, capsys):
    res = serve.main(LM_SMOKE + ["--packed", "--binarize", mode, "--max-new-skew", "1"])
    out = capsys.readouterr().out
    assert "packed weights: " in out and "served 3 requests in" in out and "tok/s" in out
    assert isinstance(res, serve.LMServeResult) and len(res.batcher.completed) == 3
    leaf = res.engine.params["layers"]["mlp"]["wi"]
    assert leaf.packed.shape[0] == res.cfg.n_layers
    assert (type(leaf) is XnorLinear) == (mode == "xnor")
    assert res.pack_seconds is not None and res.tokens == sum(
        len(r.generated) for r in res.batcher.completed)


def test_cli_packed_line_equals_the_reference(capsys, monkeypatch):
    """The bytes line: the port's init draws other values, but the shapes,
    and so the bytes, are the reference's."""
    from repro.launch import serve as jserve

    serve.main(LM_SMOKE + ["--packed"])
    mine = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("packed")]
    monkeypatch.setattr("sys.argv", ["serve", "--packed"] + [
        a for a in LM_SMOKE if a not in ("--device", "cpu")])
    jserve.main()
    ref = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("packed")]
    assert mine == ref and len(mine) == 1


def test_cli_dense_serve_and_dry_plan(capsys, tmp_path):
    res = serve.main(LM_SMOKE + ["--plan", str(tmp_path / "p.json"), "--plan-report"])
    out = capsys.readouterr().out
    assert "not applied" in out and "layers/mlp/wi" in out
    assert isinstance(res.engine.params["layers"]["mlp"]["wi"], torch.Tensor)
    again = serve.main(LM_SMOKE + ["--packed", "--plan-from", str(tmp_path / "p.json")])
    assert again.plan.to_json() == res.plan.to_json()


def test_cli_trace_and_metrics(tmp_path, capsys):
    from repro_torch.obs import MetricsRegistry, validate_trace

    trace, mjson, prom = (str(tmp_path / n) for n in ("t.json", "m.json", "m.prom"))
    serve.main(LM_SMOKE + ["--packed", "--trace", trace, "--metrics-out", mjson])
    out = capsys.readouterr().out
    assert "step coverage" in out and "step latency" in out
    info = validate_trace(trace)
    assert info["root"] == "stream_serve" and info["coverage"] >= 0.95
    with open(mjson) as f:
        reg = MetricsRegistry.from_json(json.load(f))
    assert reg["serve_requests_completed_total"].value == 3
    assert reg["serve_tokens_total"].value == 6
    serve.main(LM_SMOKE + ["--no-trace-fence", "--trace", trace, "--metrics-out", prom])
    assert "# TYPE serve_step_seconds summary" in open(prom).read()


def test_cli_classifier_metrics(tmp_path):
    prom = str(tmp_path / "m.prom")
    res = serve.main(["--arch", "mnist_fc", "--device", "cpu", "--smoke", "--requests", "8",
                      "--metrics-out", prom])
    text = open(prom).read()
    assert "serve_images_total 8" in text and "# TYPE serve_batch_seconds summary" in text
    mjson = str(tmp_path / "m.json")
    serve.main(["--arch", "mnist_fc", "--device", "cpu", "--smoke", "--requests", "8",
                "--binarize", "stoch", "--ensemble", "2", "--abstain-threshold", "0.6",
                "--metrics-out", mjson])
    with open(mjson) as f:
        d = json.load(f)
    assert d["serve_vote_agreement"]["summary"]["count"] == 8
    assert d["serve_abstain_total"]["type"] == "counter"
    assert res.requests == 8


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "data,model", "--mesh-shape", "2,2", "--packed", "--binarize", "stoch",
      "--ensemble", "2"], "item 7"),
    (["--audit-collectives"], "item 8"),
    (["--analyze", "--packed"], "item 8"),
])
def test_cli_deferred_token_flags_exit_naming_the_roadmap(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(LM_SMOKE + argv)


def test_cli_chunked_prefix_serve_and_metrics(tmp_path, capsys):
    """``--prefill-chunk --prefix-cache --shared-prefix`` on the CPU: the
    two requests admitted together miss, the three after them hit the
    shared 6-token prefix (two chunks), and the serve_prefix_* series land
    in the metrics."""
    mjson = str(tmp_path / "m.json")
    res = serve.main(LM_SMOKE + ["--packed", "--requests", "5", "--prompt-len", "8",
                                 "--prefill-chunk", "3", "--prefix-cache", "16",
                                 "--shared-prefix", "6", "--metrics-out", mjson])
    out = capsys.readouterr().out
    assert "prefix cache: 3 hits / 2 misses, 18 prompt tokens skipped" in out
    assert res.prefix_cache.hits == 3 and len(res.batcher.completed) == 5
    with open(mjson) as f:
        d = json.load(f)
    assert d["serve_prefix_hits_total"]["value"] == 3
    assert d["serve_prefix_misses_total"]["value"] == 2
    assert d["serve_prefix_tokens_skipped_total"]["value"] == 18
    assert d["serve_prefix_bytes"]["value"] == res.prefix_cache.nbytes > 0
    assert d["serve_prefill_chunks_total"]["value"] > 0
    want = {r.uid: r.generated for r in res.batcher.completed}
    for r in res.batcher.completed:
        assert res.engine.generate(r.prompt[None], r.max_new).tokens[0].tolist() == want[r.uid]


def test_cli_lm_ensemble_serve_and_metrics(tmp_path, capsys):
    prom = str(tmp_path / "m.prom")
    res = serve.main(LM_SMOKE + ["--packed", "--binarize", "stoch", "--ensemble", "2",
                                 "--abstain-threshold", "0.9", "--metrics-out", prom])
    out = capsys.readouterr().out
    assert "ensemble K=2 (stoch): " in out and "ensemble uncertainty: mean vote agreement" in out
    assert "requests at threshold 0.9" in out
    assert res.replicas.k == 2 and res.engine._replicas is res.replicas
    assert res.packed_bytes == res.replicas.tree_nbytes()
    text = open(prom).read()
    assert "# TYPE serve_vote_agreement summary" in text
    assert f"serve_vote_agreement_count {res.tokens}" in text
    n_abst = sum(r.abstained for r in res.batcher.completed)
    assert (f"serve_abstain_total {n_abst}" in text) == (n_abst > 0)


@pytest.mark.parametrize("argv,flag", [
    (["--packed", "--prefill-chunk", "4", "--prefix-cache", "8", "--shared-prefix", "2"],
     "prefix cache: "),
    (["--packed", "--binarize", "stoch", "--ensemble", "2"], "ensemble K="),
])
def test_cli_summary_lines_equal_the_reference(argv, flag, capsys, monkeypatch):
    """The prefix-cache counts and the ensemble's bytes depend on the
    prompts and shapes only, so the lines equal the reference's."""
    from repro.launch import serve as jserve

    serve.main(LM_SMOKE + argv)
    mine = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(flag)]
    monkeypatch.setattr("sys.argv", ["serve"] + argv + [
        a for a in LM_SMOKE if a not in ("--device", "cpu")])
    jserve.main()
    ref = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(flag)]
    assert mine == ref and len(mine) == 1


@pytest.mark.parametrize("argv,match", [
    (["--packed", "--binarize", "stoch", "--ensemble", "2", "--prefill-chunk", "2"],
     "single-sample serving features"),
    (["--packed", "--binarize", "stoch", "--ensemble", "2", "--prefix-cache", "4"],
     "single-sample serving features"),
    (["--binarize", "stoch", "--ensemble", "2"], "add --packed --binarize stoch"),
    (["--packed", "--binarize", "det", "--ensemble", "2"], "add --packed --binarize stoch"),
])
def test_cli_rejects_the_lm_combinations_the_reference_rejects(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(LM_SMOKE + argv)


def test_cli_ensemble_needs_a_stochastic_plan(tmp_path):
    plan = str(tmp_path / "xnor.json")
    serve.main(LM_SMOKE + ["--binarize", "xnor", "--plan", plan])
    with pytest.raises(SystemExit, match="needs a stochastic plan, got mode=xnor"):
        serve.main(LM_SMOKE + ["--packed", "--plan-from", plan, "--ensemble", "2"])


@pytest.mark.parametrize("argv,match", [
    (["--arch", "musicgen_large"], "stubbed frontend"),
    (["--arch", "nonesuch"], "unknown --arch"),
    (["--arch", "mnist_fc", "--trace", "t.json"], "classifier path is fixed-batch"),
    (["--arch", "vgg16_cifar10", "--prefill-chunk", "2"], "no prompts"),
])
def test_cli_rejects_what_the_reference_rejects(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(argv + ["--smoke", "--device", "cpu"])


def test_serve_lm_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_lm(smoke=True, requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(LM_SMOKE[:3])                    # --arch starcoder2_3b --smoke


def test_cli_other_families_raise_naming_the_roadmap(capsys):
    """The hybrid (jamba) now serves through the CLI, its SMOKE config on the
    CPU; a frontend arch still exits, as the reference's CLI does."""
    res = serve.main(["--arch", "jamba_1_5_large", "--smoke", "--device", "cpu", "--packed",
                      "--requests", "3", "--slots", "2", "--prompt-len", "6", "--max-new", "2"])
    assert "served 3 requests in" in capsys.readouterr().out and res.tokens == 6
    with pytest.raises(SystemExit, match="stubbed frontend"):
        serve.main(["--arch", "internvl2_76b", "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the batcher (a copy of the reference's; mirrored rows)
# ---------------------------------------------------------------------------

class TestServingAccounting:
    def test_tokens_generated_counts_recorded_tokens(self):
        b = SlotBatcher(n_slots=2, prompt_len=2)
        max_news = [1, 3, 2]
        for i, m in enumerate(max_news):
            b.submit(np.full(2, i), max_new=m)
        cap, legacy_count = 3, 0
        while not b.idle:
            b.refill()
            for _ in range(cap):
                b.record(np.arange(2))
            legacy_count += int(b.active_mask().sum()) * cap
        b.refill()
        assert b.tokens_generated == sum(max_news) == 6
        assert sum(len(r.generated) for r in b.completed) == 6
        assert legacy_count != b.tokens_generated

    def test_tokens_generated_includes_in_flight(self):
        b = SlotBatcher(n_slots=1, prompt_len=2)
        b.submit(np.zeros(2), max_new=4)
        b.refill()
        b.record(np.zeros(1))
        assert b.tokens_generated == 1


class TestPackedParamBytes:
    def test_dense_baseline_is_true_master_bytes(self):
        tree = serve.build_model("vgg16_cifar10", 0, device="cpu", smoke=True)[0]
        params = tree["params"]
        assert params["conv"][1]["kernel"].shape[2] % 32 != 0     # K-padded
        packed = compile_plan(params, make_paper_policy(len(params["fc"])), "xnor").pack(params)
        dense_b, packed_b = packed_param_bytes(packed)
        assert dense_b == sum(leaf.numel() * 2 for _, leaf in tree_leaves_with_path(params))
        assert packed_b < dense_b

    def test_padded_word_layout_reports_master_shape(self):
        k, n, extra = 64, 8, 3
        packed = torch.zeros((k // 32 + extra, n), dtype=torch.int32)
        leaf = XnorLinear(packed, None, k)
        assert leaf.master_shape == (k, n)
        dense_b, packed_b = packed_param_bytes({"w": leaf})
        assert dense_b == k * n * 2 and packed_b == packed.numel() * 4

    def test_stacked_master_shape(self):
        from repro_torch.models.layers import PackedLinear

        assert PackedLinear(torch.zeros((5, 2, 64, 7), dtype=torch.int32), None,
                            64).master_shape == (5, 2, 64, 7)
        assert XnorConv(torch.zeros((9, 4), dtype=torch.int32), None, (3, 3),
                        20).master_shape == (3, 3, 20, 4)

    @pytest.mark.parametrize("mode", ["det", "xnor"])
    def test_lm_bytes_equal_the_reference(self, mode):
        jcfg = jcb.get_config("qwen2_5_32b", smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        jpacked = j_compile_plan(jp, J_POLICY, mode).pack(jp)
        mp = from_jax_tree(jp, device="cpu")
        mine = compile_plan(mp, DEFAULT_POLICY, mode).pack(mp)
        assert packed_param_bytes(mine) == jengine.packed_param_bytes(jpacked)
        assert serve.packed_param_bytes is packed_param_bytes


class TestSlotBatcher:
    def test_fills_and_completes(self):
        b = SlotBatcher(n_slots=2, prompt_len=4)
        for i in range(5):
            b.submit(np.full(4, i), max_new=3)
        rounds = 0
        while not b.idle:
            b.refill()
            for _ in range(3):
                b.record(np.arange(2))
            rounds += 1
        b.refill()
        assert len(b.completed) == 5 and rounds == 3
        assert all(len(r.generated) == 3 for r in b.completed)

    def test_left_pads_short_prompts(self):
        b = SlotBatcher(n_slots=1, prompt_len=6, pad_id=9)
        b.submit(np.array([1, 2]), max_new=1)
        b.refill()
        np.testing.assert_array_equal(b.prompts()[0], np.array([9, 9, 9, 9, 1, 2]))
        assert not b.slots[0].truncated

    def test_truncates_long_prompts_to_suffix(self):
        b = SlotBatcher(n_slots=1, prompt_len=4)
        b.submit(np.arange(10), max_new=1)
        b.refill()
        np.testing.assert_array_equal(b.prompts()[0], np.array([6, 7, 8, 9]))
        assert b.slots[0].truncated

    def test_refill_retires_and_reuses_slot_in_one_step(self):
        b = SlotBatcher(n_slots=2, prompt_len=2)
        for i in range(3):
            b.submit(np.full(2, i), max_new=1)
        b.refill()
        first = [r.uid for r in b.slots]
        b.record(np.arange(2))
        changed = b.refill()
        assert [r.uid for r in b.completed] == first
        assert changed == [0]
        assert b.slots[0] is not None and b.slots[0].uid == 2
        assert b.slots[1] is None and not b.idle

    def test_all_slots_empty_decodes_masked_padding(self):
        b = SlotBatcher(n_slots=3, prompt_len=4, pad_id=7)
        b.submit(np.arange(4), max_new=1)
        b.refill()
        b.record(np.arange(3))
        b.refill()
        assert b.idle and len(b.completed) == 1
        np.testing.assert_array_equal(b.active_mask(), np.zeros(3, dtype=bool))
        np.testing.assert_array_equal(b.prompts(), np.full((3, 4), 7, np.int32))
        b.record(np.arange(3))
        assert all(r is None for r in b.slots)
        assert len(b.completed[0].generated) == 1

    def test_prefilling_slots_excluded_from_ledger(self):
        b = SlotBatcher(n_slots=2, prompt_len=4)
        b.submit(np.arange(4), max_new=2)
        b.submit(np.arange(4), max_new=5)
        b.refill()
        b.mark_prefilling(1)
        assert b.active_mask().tolist() == [True, False]
        assert b.min_remaining() == 2 and not b.idle
        b.record(np.array([7, 9]))
        assert b.slots[0].generated == [7] and b.slots[1].generated == []
        assert b.slots[1].t_first is None
        b.mark_ready(1)
        assert b.active_mask().tolist() == [True, True] and b.min_remaining() == 1
        b.record(np.array([3, 4]))
        assert b.slots[1].generated == [4] and b.slots[1].t_first is not None

    def test_lifecycle_lands_on_the_tracer(self):
        from repro_torch.obs import Tracer

        tr = Tracer(fence=False)
        b = SlotBatcher(n_slots=1, prompt_len=2, tracer=tr)
        b.submit(np.zeros(2), max_new=1)
        b.refill()
        b.record(np.zeros(1))
        b.refill()
        assert [e["name"] for e in tr.events] == ["submit", "slot_refill", "request_done"]


def _check_schedule(n_slots, prompt_len, ops):
    """Drives a SlotBatcher (and the reference's, in step) through a
    submit/refill/record/prefill-toggle schedule and asserts the ledger
    invariants after every step: ``tokens_generated`` equals tokens actually
    recorded, timestamps are ordered, ``t_done`` implies the full budget,
    truncation keeps the prompt suffix, and both sides hold the same ledger."""
    rng = np.random.default_rng(1234)
    b, jb = SlotBatcher(n_slots, prompt_len), JSlotBatcher(n_slots, prompt_len)
    submitted = {}
    recorded = 0
    for op in ops:
        kind = op[0]
        if kind == "submit":
            prompt = rng.integers(0, 100, op[1]).astype(np.int32)
            uid = b.submit(prompt, op[2])
            assert jb.submit(prompt, op[2]) == uid
            submitted[uid] = (prompt, op[2])
        elif kind == "refill":
            assert b.refill() == jb.refill()
        elif kind == "record":
            active = b.active_mask()
            toks = rng.integers(0, 100, n_slots)
            b.record(toks)
            jb.record(toks)
            recorded += int(active.sum())
        elif kind == "prefill_toggle":
            slot = op[1] % n_slots
            for x in (b, jb):
                if slot in x.prefilling:
                    x.mark_ready(slot)
                elif x.slots[slot] is not None and not x.slots[slot].done:
                    x.mark_prefilling(slot)
        assert b.tokens_generated == recorded == jb.tokens_generated
        assert b.active_mask().tolist() == jb.active_mask().tolist()
        assert b.min_remaining() == jb.min_remaining() and b.idle == jb.idle
    b.refill()
    live = [r for r in b.slots if r is not None]
    for r in b.completed + live + list(b.queue):
        prompt, max_new = submitted[r.uid]
        assert len(r.generated) <= max_new
        if r.t_first is not None:
            assert r.t_submit <= r.t_first
        if r.t_done is not None:
            assert r.t_first is not None and r.t_first <= r.t_done
            assert len(r.generated) == max_new
        if len(prompt) >= b.prompt_len:
            np.testing.assert_array_equal(r.prompt, prompt[-b.prompt_len:])
            assert r.truncated == (len(prompt) > b.prompt_len)
        else:
            np.testing.assert_array_equal(r.prompt[b.prompt_len - len(prompt):], prompt)
            assert not r.truncated and (r.prompt[:b.prompt_len - len(prompt)] == b.pad_id).all()


from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


class TestSlotBatcherProperties:
    """Property-based ledger invariants over the schedule space."""

    @settings(max_examples=60, deadline=None)
    @given(n_slots=st.integers(1, 4), prompt_len=st.integers(1, 8),
           ops=st.lists(st.one_of(
               st.tuples(st.just("submit"), st.integers(1, 12), st.integers(1, 6)),
               st.tuples(st.just("refill")),
               st.tuples(st.just("record")),
               st.tuples(st.just("prefill_toggle"), st.integers(0, 7))), max_size=60))
    def test_ledger_invariants(self, n_slots, prompt_len, ops):
        _check_schedule(n_slots, prompt_len, ops)


class TestSlotBatcherRandomSchedules:
    def test_ledger_invariants_random(self):
        """Seeded sweep over 40 random schedules through the same checker."""
        rng = np.random.default_rng(7)
        for _ in range(40):
            ops = []
            for _ in range(int(rng.integers(0, 60))):
                kind = int(rng.integers(0, 4))
                if kind == 0:
                    ops.append(("submit", int(rng.integers(1, 13)), int(rng.integers(1, 7))))
                elif kind == 1:
                    ops.append(("refill",))
                elif kind == 2:
                    ops.append(("record",))
                else:
                    ops.append(("prefill_toggle", int(rng.integers(0, 8))))
            _check_schedule(int(rng.integers(1, 5)), int(rng.integers(1, 9)), ops)
