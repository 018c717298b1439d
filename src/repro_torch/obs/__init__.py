"""Serving observability: tracing, metrics, and the static collective
prediction.

Module map::

    trace.py        Tracer: low-overhead span API threaded through
                    ServeEngine.prefill_into / decode_step / stream_serve
                    and the SlotBatcher refill path; host vs device time
                    split by a torch.cuda.synchronize fence (only while
                    tracing); Chrome trace-event JSON export viewable in
                    Perfetto; validate_trace / ``python -m repro_torch.obs``
                    schema and span-coverage checker.
    metrics.py      MetricsRegistry: process-local counters / gauges /
                    histograms (tok/s, TTFT, per-step latency, queue depth,
                    slot occupancy, ensemble vote agreement and abstains)
                    with numpy-exact p50/p95/p99 summaries, lossless JSON
                    round trip and Prometheus text export.
    collectives.py  predict_row_collective, which feeds plan_report's
                    "collectives" column. The audit of a compiled program's
                    collectives waits for a mesh (ROADMAP, queue 1 item 8).

Entry points: ``launch.serve --trace out.json --metrics-out m.json``;
``stream_serve(..., metrics=registry)``; ``ServeEngine(..., tracer=Tracer())``.
"""
from repro_torch.obs.collectives import predict_row_collective
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                     record_request_metrics)
from repro_torch.obs.trace import NULL_TRACER, Tracer, validate_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACER", "Tracer",
    "predict_row_collective", "record_request_metrics", "validate_trace",
]
