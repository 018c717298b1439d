"""Serving layer: step-level continuous batching over packed binary weights.

* ``engine``: :class:`ServeEngine` (prefill / ``prefill_into`` /
  ``decode_step`` / ``decode_steps`` over one parameter tree, on the device
  it lives on), :class:`DecodeState` (the persistent slot-addressed KV cache
  and per-slot next-token logits), :func:`stream_serve` (the step-level
  serving loop) and ``packed_param_bytes`` (weight bytes from true master
  shapes);
* ``batcher``: :class:`SlotBatcher` / :class:`Request`, the fixed-slot
  request queue with suffix truncation to the prompt width, per-request
  ``max_new``, and the TTFT / latency / tokens-recorded ledger the
  throughput numbers come from.

The prefix cache (``prefix_cache.py``) waits for ROADMAP queue 1 item 6b.
"""
from repro_torch.serve.batcher import Request, SlotBatcher
from repro_torch.serve.engine import (DecodeState, GenerationResult, ServeEngine,
                                      packed_param_bytes, stream_serve)

__all__ = [
    "DecodeState", "GenerationResult", "Request", "ServeEngine", "SlotBatcher",
    "packed_param_bytes", "stream_serve",
]
