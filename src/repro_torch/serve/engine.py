"""Serving engine: packed-weight LM inference with prefill and batched
decode, single device (the reference's ``repro/serve/engine.py``).

Which datapath each projection gets is decided by the execution plan
(``repro_torch.engine``: ``compile_plan(...).pack``), and the model
dispatches through ``apply_linear`` on the serving leaves the plan
produced (K2 for ``packed``, K3 + K4 for ``xnor``).

Serving is step-level continuously batched (:func:`stream_serve`): the KV
cache is a persistent slot-addressed structure (:class:`DecodeState`), a
finished request's slot is re-prefilled from the queue mid-stream
(``ServeEngine.prefill_into``), and one decode step advances every slot.
Where the reference jits a fixed-shape program, the port runs eager
PyTorch: every entry point keeps the reference's shapes, and the cache is
written in place where the reference donates it.

Left for ROADMAP queue 1 item 6b, each raising ``NotImplementedError``:
temperature sampling, the LM ensemble (``ensemble=``), chunked prefill
(``prefill_chunk``, ``prefill_chunk_into``, ``fused_step``) and the prefix
cache (``prefix_cache``, ``capture_slot``, ``splice_into``); a mesh
(``mesh=``) waits for item 7.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import record_request_metrics
from repro_torch.obs.trace import NULL_TRACER

_ITEM_6B = "ROADMAP queue 1 item 6b"


def _not_ported(what: str, item: str = _ITEM_6B) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


def packed_param_bytes(params) -> tuple[int, int]:
    """(dense bf16 bytes, served bytes): a serving leaf counts its master
    shape, stack dims included, on the dense side (never its word count,
    which includes pad words) and its words and scale on the served side;
    every other leaf counts its bf16 size on both sides."""
    dense = packed = 0
    for _, leaf in tree_leaves_with_path(params):
        if hasattr(leaf, "master_shape"):
            dense += math.prod(leaf.master_shape) * 2
            packed += leaf.nbytes()
        else:
            dense += leaf.numel() * 2
            packed += leaf.numel() * 2
    return dense, packed


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GenerationResult:
    """Greedy tokens and their log-probabilities under ``softmax(logits)``."""

    tokens: torch.Tensor       # (B, max_new) int32
    logprobs: torch.Tensor     # (B, max_new) f32
    steps: int


@dataclasses.dataclass
class DecodeState:
    """Live state of the continuous-batching engine: one long-lived,
    slot-addressed KV cache plus the next-token logits of every slot.
    Requests come and go (``prefill_into``); the shapes never change."""

    cache: dict                # slot-addressed decode cache (B = n_slots)
    logits: torch.Tensor       # (n_slots, vocab) next-token logits per slot
    n_slots: int
    prompt_len: int
    max_new_cap: int           # per-request max_new must be <= this

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.max_new_cap


class ServeEngine:
    """Batched prefill + greedy decode over a (possibly packed) parameter
    tree, on the device its tensors live on.

    * one-shot: ``generate(prompts, max_new)``: prefill a batch, decode
      every row for ``max_new`` steps;
    * continuous batching: ``init_decode`` builds a persistent
      slot-addressed :class:`DecodeState`, ``prefill_into`` splices a fresh
      request into it at a slot, and ``decode_step`` advances all slots one
      token. ``stream_serve`` drives the loop against a ``SlotBatcher``.

    ``tracer`` (``repro_torch.obs.Tracer``) wraps ``prefill_into``,
    ``decode_step`` and ``decode_steps`` in spans with a ``dispatch`` child
    (the call returns with its kernels queued) and a ``device`` child (the
    tracer's fence waits for the card); the default ``NULL_TRACER`` makes
    every span site a no-op."""

    def __init__(self, cfg, params, *, mesh=None, plan=None, ensemble=None, tracer=None):
        if ensemble is not None:
            raise _not_ported("LM ensemble serving (ServeEngine(ensemble=...))")
        if mesh is not None or plan is not None:
            raise _not_ported("mesh-placed serving (ServeEngine(mesh=..., plan=...))",
                              "ROADMAP queue 1 item 7")
        T.require_dense(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["embedding"].device
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def _tokens(self, tokens, shape) -> torch.Tensor:
        """``tokens`` (a tensor, array or list) as int32 on the engine's device."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens, np.int32))
        return tokens.to(self.device, torch.int32).reshape(shape)

    @torch.inference_mode()
    def generate(self, prompts, max_new: int, temperature: float = 0.0) -> GenerationResult:
        """Greedy generation of ``max_new`` tokens for each row of ``prompts`` (B, S)."""
        if temperature > 0.0:
            raise _not_ported("temperature sampling (it needs a twin of "
                              "jax.random.categorical)")
        prompts = self._tokens(prompts, (len(prompts), -1))
        logits, cache = T.prefill(self.cfg, self.params, prompts,
                                  max_len=prompts.shape[1] + max_new)
        toks, lps = [], []
        for i in range(max_new):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            lps.append(lp.gather(-1, tok[:, None].long())[:, 0])
            toks.append(tok)
            if i < max_new - 1:
                logits, cache = T.decode_step(self.cfg, self.params, cache, tok[:, None])
        return GenerationResult(torch.stack(toks, 1), torch.stack(lps, 1), max_new)

    # -- step-level continuous batching -----------------------------------

    @torch.inference_mode()
    def init_decode(self, n_slots: int, prompt_len: int, max_new_cap: int) -> DecodeState:
        """A zeroed slot-addressed cache for ``prompt_len + max_new_cap``
        positions and an empty next-token logits buffer; slots fill with
        ``prefill_into``, and empty slots decode padding."""
        cache = T.init_cache(self.cfg, n_slots, prompt_len + max_new_cap, device=self.device)
        logits = torch.zeros((n_slots, self.cfg.vocab_size), dtype=self.cfg.activation_dtype,
                             device=self.device)
        return DecodeState(cache, logits, n_slots, prompt_len, max_new_cap)

    @torch.inference_mode()
    def prefill_into(self, state: DecodeState, slot: int, prompt) -> DecodeState:
        """Prefills one request (a prompt of ``prompt_len`` tokens) and
        writes its cache rows and first-token logits into ``state`` at
        ``slot``, in place. Returns the state."""
        tr = self.tracer
        prompt = self._tokens(prompt, (1, state.prompt_len))
        with tr.span("prefill_into", slot=slot):
            with tr.span("dispatch"):
                lg, one = T.prefill(self.cfg, self.params, prompt, max_len=state.context_len)
                state.logits[slot] = lg[0].to(state.logits.dtype)
                T.cache_insert(self.cfg, state.cache, one, slot)
            with tr.span("device"):
                tr.fence(state.logits)
        return state

    @torch.inference_mode()
    def decode_step(self, state: DecodeState, tokens) -> DecodeState:
        """Advances every slot one token. ``tokens`` (n_slots,): the token
        just emitted per slot; inactive slots feed padding and their outputs
        are ignored."""
        tr = self.tracer
        tokens = self._tokens(tokens, (state.n_slots, 1))
        with tr.span("decode_step"):
            with tr.span("dispatch"):
                logits, cache = T.decode_step(self.cfg, self.params, state.cache, tokens)
            with tr.span("device"):
                tr.fence(logits)
        return dataclasses.replace(state, cache=cache, logits=logits)

    @torch.inference_mode()
    def decode_steps(self, state: DecodeState, d: int):
        """Advances every slot ``d`` greedy tokens (argmax, decode, repeat)
        with no host read between them. Returns ``(new_state, tokens)``,
        ``tokens`` a (n_slots, d) int32 device tensor, so the serving loop
        reads the host once per ``d`` tokens. ``state.logits`` stays the
        not-yet-emitted next-token logits."""
        tr = self.tracer
        cache, logits, toks = state.cache, state.logits, []
        with tr.span("decode_steps", d=d):
            with tr.span("dispatch"):
                for _ in range(d):
                    tok = torch.argmax(logits, dim=-1).to(torch.int32)
                    lg, cache = T.decode_step(self.cfg, self.params, cache, tok[:, None])
                    logits = lg.to(logits.dtype)
                    toks.append(tok)
            with tr.span("device"):
                tr.fence(logits)
        return dataclasses.replace(state, cache=cache, logits=logits), torch.stack(toks, 1)

    def prefill_chunk_into(self, state, slot, tokens, offset):
        raise _not_ported("chunked prefill (prefill_chunk_into)")

    def fused_step(self, state, tokens, keep_mask, slot, chunk_tokens, offset):
        raise _not_ported("chunked prefill (fused_step)")

    def capture_slot(self, state, slot):
        raise _not_ported("the prefix cache (capture_slot)")

    def splice_into(self, state, slot, cache_rows, logits_row=None):
        raise _not_ported("the prefix cache (splice_into)")


def stream_serve(engine: ServeEngine, batcher, *, max_new_cap: Optional[int] = None,
                 temperature: float = 0.0, metrics=None, decode_chunk: int = 1,
                 prefill_chunk: int = 0, prefix_cache=None) -> int:
    """Step-level continuous-batching serving loop, greedy, whole-prompt
    admission.

    Each iteration retires finished requests and re-prefills their slots
    from the queue (``batcher.refill``), emits one token for every active
    slot from the state's next-token logits, then runs one decode step over
    all slots. A request finishing mid-stream frees its slot for the next
    queued request on the next step, and per-request ``max_new`` is honoured
    exactly. ``max_new_cap`` sizes the persistent cache (default: the
    largest ``max_new`` queued). Returns the number of token-emission steps
    (the model runs ``steps - 1`` decode steps plus one prefill a request).

    ``decode_chunk > 1`` runs ``d = min(decode_chunk, shortest live
    request's remaining budget)`` decode steps a call
    (``ServeEngine.decode_steps``) and reads the host once per ``d``
    tokens; slot turnover stays on the chunk boundary, so every stream is
    the one-token loop's.

    Observability: the engine's tracer wraps the loop in a ``stream_serve``
    span with one ``step`` span an iteration (``refill`` / ``sample`` /
    ``record`` children; the engine adds ``prefill_into`` / ``decode_step``
    with their dispatch/device split). ``metrics`` (a
    ``repro_torch.obs.MetricsRegistry``) records per-step latency, queue
    depth and slot occupancy, prefill/step/token counters, the ledger's
    TTFT/latency histograms and a ``serve_tok_per_s`` gauge.

    Not ported yet, each raising ``NotImplementedError``: ``temperature >
    0``, ``prefill_chunk > 0`` and ``prefix_cache`` (ROADMAP queue 1 item
    6b)."""
    if temperature > 0.0:
        raise _not_ported("temperature sampling")
    if prefill_chunk > 0 or prefix_cache is not None:
        raise _not_ported("chunked prefill and the prefix cache "
                          "(stream_serve(prefill_chunk=..., prefix_cache=...))")
    cap = max_new_cap
    if cap is None:
        pending = [r.max_new for r in batcher.queue]
        if not pending:
            return 0
        cap = max(pending)
    tr = engine.tracer
    step_h = queue_h = occ_h = None
    if metrics is not None:
        step_h = metrics.histogram("serve_step_seconds", "wall seconds per serving-loop step")
        queue_h = metrics.histogram("serve_queue_depth", "queued requests, sampled per step")
        occ_h = metrics.histogram("serve_slot_occupancy",
                                  "active-slot fraction, sampled per step")
    t_start = time.perf_counter()
    steps = 0
    with tr.span("stream_serve", n_slots=batcher.n_slots, cap=cap):
        with tr.span("init_decode"):
            state = engine.init_decode(batcher.n_slots, batcher.prompt_len, cap)
        try:
            while True:
                t_step = time.perf_counter()
                with tr.span("step", step=steps):
                    with tr.span("refill"):
                        for slot in batcher.refill():
                            req = batcher.slots[slot]
                            if req.max_new > cap:
                                raise ValueError(
                                    f"request {req.uid} wants max_new={req.max_new} but "
                                    f"the decode state was sized for max_new_cap={cap}")
                            if metrics is not None:
                                metrics.counter("serve_prefills_total",
                                                "slot prefills (one per request "
                                                "admitted)").inc()
                            state = engine.prefill_into(state, slot, req.prompt)
                    if metrics is not None:
                        queue_h.observe(len(batcher.queue))
                        occ_h.observe(float(np.mean(batcher.active_mask())))
                    if batcher.idle:
                        return steps
                    if decode_chunk > 1:
                        d = min(decode_chunk, batcher.min_remaining())
                        with tr.span("chunk", d=d):
                            state, toks = engine.decode_steps(state, d)
                            tok_chunk = toks.cpu().numpy()       # the chunk's one host read
                        with tr.span("record"):
                            for i in range(d):
                                batcher.record(tok_chunk[:, i])
                        steps += d
                        if metrics is not None:
                            metrics.counter("serve_steps_total",
                                            "token-emission steps").inc(d)
                        if batcher.idle:
                            batcher.refill()
                        if step_h is not None:
                            step_h.observe(time.perf_counter() - t_step)
                        if batcher.idle:
                            return steps
                        continue
                    with tr.span("sample"):
                        tok = torch.argmax(state.logits, dim=-1)
                        tok_host = tok.cpu().numpy()
                    with tr.span("record"):
                        batcher.record(tok_host)
                    steps += 1
                    if metrics is not None:
                        metrics.counter("serve_steps_total", "token-emission steps").inc()
                    if batcher.idle:
                        # flush the final completions; a trailing decode
                        # step would be pure waste
                        batcher.refill()
                        if step_h is not None:
                            step_h.observe(time.perf_counter() - t_step)
                        return steps
                    state = engine.decode_step(state, tok)
                if step_h is not None:
                    step_h.observe(time.perf_counter() - t_step)
        finally:
            if metrics is not None:
                record_request_metrics(metrics, batcher)
                dt = time.perf_counter() - t_start
                if dt > 0:
                    metrics.gauge("serve_tok_per_s",
                                  "recorded tokens / serving wall seconds").set(
                        batcher.tokens_generated / dt)
