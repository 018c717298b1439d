"""Request batcher: groups incoming generation requests into fixed-shape
batches (slot-based continuous batching), a copy of the reference's
``repro/serve/batcher.py`` (numpy only).

The engine keeps a fixed number of *slots* (the decode batch dimension).
Finished slots are refilled from the queue each step; empty slots decode
padding and are masked out of the returned streams.

The batcher is also the accounting ledger: every request records submit /
first-token / completion wall times (TTFT and per-request latency) and its
generated tokens, so serving throughput is derived from tokens *actually
recorded* (``tokens_generated``), never from steps-times-batch arithmetic.
The batcher is host-side bookkeeping and never touches device state.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Deque, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    truncated: bool = False       # prompt was longer than the slot width
    t_submit: float = 0.0         # wall time at submit()
    t_first: Optional[float] = None   # wall time of the first recorded token
    t_done: Optional[float] = None    # wall time of the last recorded token
    # Per-token ensemble uncertainty (only filled under K-replica serving,
    # which the port's LM engine does not run yet): replica vote agreement and mean logit variance aligned
    # with ``generated``; ``abstained`` latches once any recorded token's
    # agreement fell below the engine's abstain threshold.
    agreement: list[float] = dataclasses.field(default_factory=list)
    variance: list[float] = dataclasses.field(default_factory=list)
    abstained: bool = False

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    @property
    def ttft(self) -> Optional[float]:
        """Submit-to-first-token seconds (includes queue wait)."""
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-last-token seconds (includes queue wait)."""
        return None if self.t_done is None else self.t_done - self.t_submit


class SlotBatcher:
    def __init__(self, n_slots: int, prompt_len: int, pad_id: int = 0,
                 tracer=None):
        self.n_slots = n_slots
        self.prompt_len = prompt_len
        self.pad_id = pad_id
        self.queue: Deque[Request] = collections.deque()
        self.slots: list[Optional[Request]] = [None] * n_slots
        self._uid = itertools.count()
        self.completed: list[Request] = []
        # Slots whose prompt is still being prefilled chunk-by-chunk
        # (stream_serve's chunked-prefill mode): the request occupies the
        # slot (so it is never refilled and the stream is not idle) but it
        # is NOT active — record() skips it, so no decode garbage lands in
        # its ledger and t_first stamps on the first *generated* token,
        # never on a prefill chunk's completion.
        self.prefilling: set[int] = set()
        # Optional repro_torch.obs.Tracer: the request lifecycle (submit ->
        # slot_refill -> request_done) lands as instant events on the same
        # timeline as the engine's spans, so queue waits are visible in the
        # trace. Disabled tracer = every call is a no-op.
        if tracer is None:
            from repro_torch.obs.trace import NULL_TRACER as tracer
        self.tracer = tracer

    def submit(self, prompt: np.ndarray, max_new: int) -> int:
        uid = next(self._uid)
        p = np.asarray(prompt, np.int32)
        truncated = p.shape[0] > self.prompt_len
        if truncated:
            # keep the LAST prompt_len tokens: the next token conditions on
            # the suffix, so dropping the head loses far less context than
            # dropping the tail would
            p = p[-self.prompt_len:]
        elif p.shape[0] < self.prompt_len:  # left-pad to static shape
            p = np.concatenate(
                [np.full(self.prompt_len - p.shape[0], self.pad_id, np.int32), p])
        self.queue.append(Request(uid, p, max_new, truncated=truncated,
                                  t_submit=time.perf_counter()))
        self.tracer.instant("submit", uid=uid, max_new=max_new,
                            queued=len(self.queue))
        return uid

    def refill(self) -> list[int]:
        """Fills free slots from the queue; returns indices that changed."""
        changed = []
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                self.completed.append(r)
                self.slots[i] = None
                self.tracer.instant("request_done", uid=r.uid, slot=i,
                                    tokens=len(r.generated))
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                changed.append(i)
                self.tracer.instant("slot_refill", uid=self.slots[i].uid,
                                    slot=i, queued=len(self.queue))
        return changed

    def mark_prefilling(self, slot: int) -> None:
        """Flag a slot as mid-chunked-prefill: occupied but not yet
        decoding (excluded from record / active_mask / min_remaining)."""
        self.prefilling.add(slot)

    def mark_ready(self, slot: int) -> None:
        """Prefill finished: the slot joins the active decode set."""
        self.prefilling.discard(slot)

    def active_mask(self) -> np.ndarray:
        return np.array([r is not None and not r.done
                         and i not in self.prefilling
                         for i, r in enumerate(self.slots)])

    def prompts(self) -> np.ndarray:
        out = np.full((self.n_slots, self.prompt_len), self.pad_id, np.int32)
        for i, r in enumerate(self.slots):
            if r is not None:
                out[i] = r.prompt
        return out

    def record(self, tokens: np.ndarray, agreement=None, variance=None,
               abstained=None) -> None:
        """Append one emitted token per live slot; the optional per-slot
        arrays (ensemble serving) append the matching uncertainty stats."""
        now = time.perf_counter()
        for i, r in enumerate(self.slots):
            if i in self.prefilling:
                continue
            if r is not None and not r.done:
                if r.t_first is None:
                    r.t_first = now
                r.generated.append(int(tokens[i]))
                if agreement is not None:
                    r.agreement.append(float(agreement[i]))
                if variance is not None:
                    r.variance.append(float(variance[i]))
                if abstained is not None and bool(abstained[i]):
                    r.abstained = True
                if r.done:
                    r.t_done = now

    def min_remaining(self) -> Optional[int]:
        """Smallest remaining-token budget among live slots (None when no
        slot is active). The multi-step decode loop (``stream_serve``'s
        ``decode_chunk``) sizes each on-device chunk to this, so no request
        finishes strictly *inside* a chunk: completions land exactly on the
        chunk boundary, where the refill runs — slot turnover timing (and
        therefore every stream) is bit-identical to the one-token loop."""
        rem = [r.max_new - len(r.generated)
               for i, r in enumerate(self.slots)
               if r is not None and not r.done and i not in self.prefilling]
        return min(rem) if rem else None

    @property
    def tokens_generated(self) -> int:
        """Tokens actually recorded so far (completed + in-flight). The
        serving loops derive tok/s from this — counting steps * batch over-
        credits requests whose per-request ``max_new`` is below the cap and
        misses slots that finished inside the current round/step."""
        live = sum(len(r.generated) for r in self.slots if r is not None)
        return live + sum(len(r.generated) for r in self.completed)

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None or r.done for r in self.slots)
