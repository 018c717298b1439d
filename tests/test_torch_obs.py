"""The port's observability (``repro_torch.obs``) against the reference's.

The reference's ``tests/test_obs.py`` is mirrored here on the port: the
tracer's span schema and disabled-tracer no-ops, histogram percentiles
against numpy, the metrics exports and a traced serving loop on the CPU.
Beyond the mirror, the same observations fed to both registries give the
same percentiles, the same JSON and the same Prometheus and table text,
byte for byte, and each side's ``validate_trace`` accepts the other's
trace.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import metrics as j_metrics
from repro.obs import trace as j_trace
from repro_torch.obs.metrics import (Counter, Histogram, MetricsRegistry,
                                     record_request_metrics)
from repro_torch.obs.trace import _NULL_SPAN, NULL_TRACER, Tracer, validate_trace

SRC = Path(__file__).resolve().parents[1] / "src"


class TestHistogram:
    def test_percentiles_match_numpy_quantiles(self):
        rng = np.random.default_rng(0)
        xs = rng.gamma(2.0, 3.0, size=257)
        h = Histogram("h")
        for x in xs:
            h.observe(float(x))
        for q in (0, 25, 50, 90, 95, 99, 100):
            assert h.percentile(q) == pytest.approx(float(np.quantile(xs, q / 100.0)),
                                                    rel=1e-12)
        s = h.summary()
        assert s["count"] == 257
        assert (s["p50"], s["p95"], s["p99"]) == (h.percentile(50), h.percentile(95),
                                                  h.percentile(99))
        assert s["min"] == float(xs.min()) and s["max"] == float(xs.max())

    def test_empty_histogram(self):
        h = Histogram("h")
        assert h.percentile(50) is None
        assert h.summary() == {"count": 0}
        assert h.sum == 0.0 and h.count == 0

    def test_counter_rejects_decrease(self):
        c = Counter("c")
        c.inc(2)
        with pytest.raises(ValueError):
            c.inc(-1)
        assert c.value == 2


def _populate(reg, seed: int):
    """The same observations into either side's registry."""
    rng = np.random.default_rng(seed)
    reg.counter("serve_tokens_total", "tokens").inc(42 + seed)
    reg.counter("serve_steps_total").inc(3)
    reg.gauge("serve_tok_per_s", "throughput").set(316.5 * (seed + 1))
    h = reg.histogram("serve_step_seconds", "step wall")
    for v in rng.gamma(2.0, 0.01, size=5 + 40 * seed):
        h.observe(float(v))
    reg.histogram("serve_empty_seconds", "never observed")
    return reg


class TestMetricsRegistry:
    def test_json_round_trip_is_lossless(self):
        reg = _populate(MetricsRegistry(), 0)
        back = MetricsRegistry.from_json(json.loads(json.dumps(reg.to_json())))
        assert back.to_json() == reg.to_json()
        assert back["serve_step_seconds"].samples == reg["serve_step_seconds"].samples

    def test_save_round_trip(self, tmp_path):
        reg = _populate(MetricsRegistry(), 1)
        path = reg.save(str(tmp_path / "m.json"))
        with open(path) as f:
            assert MetricsRegistry.from_json(json.load(f)).to_json() == reg.to_json()

    def test_type_conflict_raises(self):
        reg = _populate(MetricsRegistry(), 0)
        with pytest.raises(TypeError):
            reg.gauge("serve_tokens_total")
        with pytest.raises(TypeError):
            reg.histogram("serve_tok_per_s")
        with pytest.raises(ValueError, match="unknown metric type"):
            MetricsRegistry.from_json({"x": {"type": "meter"}})

    def test_get_or_create_returns_same_object(self):
        reg = MetricsRegistry()
        assert reg.counter("a") is reg.counter("a")
        assert "a" in reg and "b" not in reg
        assert reg.names() == ["a"]

    def test_prometheus_text(self):
        reg = MetricsRegistry()
        reg.counter("serve_tokens_total", "tokens").inc(42)
        reg.gauge("serve_tok_per_s", "throughput").set(316.5)
        h = reg.histogram("serve_step_seconds", "step wall")
        for v in (0.01, 0.02, 0.03, 0.05):
            h.observe(v)
        text = reg.to_prometheus()
        assert "# TYPE serve_tokens_total counter" in text
        assert "serve_tokens_total 42" in text
        assert "# TYPE serve_tok_per_s gauge" in text
        assert "# TYPE serve_step_seconds summary" in text
        assert 'serve_step_seconds{quantile="0.5"}' in text
        assert "serve_step_seconds_sum 0.11" in text
        assert "serve_step_seconds_count 4" in text
        assert text.endswith("\n")

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_exports_equal_the_reference_byte_for_byte(self, seed, tmp_path):
        mine = _populate(MetricsRegistry(), seed)
        ref = _populate(j_metrics.MetricsRegistry(), seed)
        assert mine.to_prometheus() == ref.to_prometheus()
        assert mine.format_table() == ref.format_table()
        assert json.dumps(mine.to_json(), sort_keys=True) == json.dumps(ref.to_json(),
                                                                        sort_keys=True)
        assert (Path(mine.save(str(tmp_path / "a.json"))).read_bytes()
                == Path(ref.save(str(tmp_path / "b.json"))).read_bytes())
        for q in (0, 50, 95, 99, 100):
            assert (mine["serve_step_seconds"].percentile(q)
                    == ref["serve_step_seconds"].percentile(q))
        # each side reads the other's JSON back to the same registry
        assert (MetricsRegistry.from_json(ref.to_json()).to_prometheus()
                == j_metrics.MetricsRegistry.from_json(mine.to_json()).to_prometheus())


class TestTracerDisabled:
    def test_span_is_shared_null_singleton(self):
        tr = Tracer(enabled=False)
        s = tr.span("decode_step", step=3)
        assert s is tr.span("other") is _NULL_SPAN
        assert NULL_TRACER.span("x") is _NULL_SPAN
        with s:
            pass
        tr.instant("submit", uid=0)
        assert tr.events == []

    def test_fence_passthrough(self):
        """A disabled or unfenced tracer returns the value untouched; an
        enabled one passes CPU tensors (nested too) straight through."""
        obj = object()
        assert NULL_TRACER.fence(obj) is obj
        assert Tracer(enabled=True, fence=False).fence(obj) is obj
        value = {"a": torch.zeros(2), "b": [torch.ones(1), (torch.ones(1), 3)]}
        assert Tracer().fence(value) is value


class TestTracerEvents:
    def _traced(self, tracer_cls=Tracer):
        tr = tracer_cls(fence=False, pid=7)
        with tr.span("root", cap=4):
            with tr.span("child", k=1):
                time.sleep(0.002)
            with tr.span("child2"):
                time.sleep(0.001)
        tr.instant("mark", uid=9)
        return tr

    def test_chrome_trace_schema(self):
        trace = self._traced().to_json()
        info = validate_trace(trace)
        assert info["spans"] == 3 and info["root"] == "root"
        assert 0.0 < info["coverage"] <= 1.0
        spans = {e["name"]: e for e in trace["traceEvents"] if e.get("ph") == "X"}
        assert spans["root"]["args"]["depth"] == 0
        assert spans["child"]["args"] == {"k": 1, "depth": 1}
        assert spans["child2"]["args"]["depth"] == 1
        for e in spans.values():
            assert e["cat"] == "serve" and e["pid"] == 7 and e["dur"] >= 0
        marks = [e for e in trace["traceEvents"] if e.get("ph") == "i"]
        assert len(marks) == 1 and marks[0]["args"] == {"uid": 9}

    def test_sleep_children_dominate_root(self):
        assert validate_trace(self._traced().to_json())["coverage"] >= 0.9

    def test_save_and_file_validation(self, tmp_path):
        path = self._traced().save(str(tmp_path / "t.json"))
        info = validate_trace(path)
        assert info["spans"] == 3 and info["events"] == 5      # +1 meta, +1 mark

    def test_events_sorted_by_ts(self):
        ts = [e["ts"] for e in self._traced().to_json()["traceEvents"] if e.get("ph") != "M"]
        assert ts == sorted(ts)

    def test_validate_rejects_bad_traces(self):
        with pytest.raises(ValueError, match="traceEvents"):
            validate_trace({"events": []})
        with pytest.raises(ValueError, match="missing 'dur'"):
            validate_trace({"traceEvents": [
                {"name": "a", "ph": "X", "ts": 0, "pid": 1, "tid": 1}]})
        with pytest.raises(ValueError, match="monotonic"):
            validate_trace({"traceEvents": [
                {"name": "a", "ph": "X", "ts": 5, "dur": 1, "pid": 1, "tid": 1},
                {"name": "b", "ph": "X", "ts": 2, "dur": 1, "pid": 1, "tid": 1}]})
        with pytest.raises(ValueError, match="negative"):
            validate_trace({"traceEvents": [
                {"name": "a", "ph": "X", "ts": 0, "dur": -1, "pid": 1, "tid": 1}]})

    def test_each_side_validates_the_others_trace(self):
        mine = self._traced().to_json()
        ref = self._traced(j_trace.Tracer).to_json()
        for trace in (mine, ref):
            a, b = validate_trace(trace), j_trace.validate_trace(trace)
            assert a == b and a["root"] == "root" and a["spans"] == 3

    def test_cli_validates_and_gates_coverage(self, tmp_path):
        path = self._traced().save(str(tmp_path / "t.json"))
        env = {"PYTHONPATH": str(SRC)}
        ok = subprocess.run([sys.executable, "-m", "repro_torch.obs", path], env=env,
                            capture_output=True, text=True, timeout=120)
        assert ok.returncode == 0, ok.stderr
        assert "valid" in ok.stdout and "root='root'" in ok.stdout
        strict = subprocess.run([sys.executable, "-m", "repro_torch.obs", path,
                                 "--min-coverage", "1.01"], env=env, capture_output=True,
                                text=True, timeout=120)
        assert strict.returncode != 0 and "below required" in strict.stderr


class TestTracedServing:
    """End to end: the port's traced and metered serving loop on the CPU."""

    def _serve(self):
        from repro_torch.configs import base as cb
        from repro_torch.models import transformer as T
        from repro_torch.serve import ServeEngine, SlotBatcher, stream_serve

        cfg = cb.get_config("starcoder2_3b", smoke=True)
        params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        tracer = Tracer()
        engine = ServeEngine(cfg, params, tracer=tracer)
        batcher = SlotBatcher(2, 4, tracer=tracer)
        rng = np.random.default_rng(0)
        metrics = MetricsRegistry()
        for _ in range(4):
            batcher.submit(rng.integers(0, cfg.vocab_size, 4), 3)
        steps = stream_serve(engine, batcher, max_new_cap=3, metrics=metrics)
        return tracer, metrics, batcher, steps

    def test_trace_covers_serving_loop(self):
        tracer, metrics, batcher, steps = self._serve()
        info = validate_trace(tracer.to_json())
        assert info["root"] == "stream_serve"
        assert info["coverage"] >= 0.95
        assert j_trace.validate_trace(tracer.to_json()) == info
        names = {e["name"] for e in tracer.events}
        assert {"stream_serve", "init_decode", "step", "refill", "prefill_into",
                "decode_step", "dispatch", "device", "sample", "record", "submit",
                "slot_refill", "request_done"} <= names
        assert metrics.counter("serve_steps_total").value == steps
        assert (metrics.counter("serve_tokens_total").value
                == batcher.tokens_generated == 12)
        assert metrics.counter("serve_requests_completed_total").value == 4
        assert metrics.counter("serve_prefills_total").value == 4
        assert metrics.histogram("serve_ttft_seconds").count == 4
        assert metrics.histogram("serve_step_seconds").count == steps
        assert metrics.gauge("serve_tok_per_s").value > 0
        occ = metrics.histogram("serve_slot_occupancy")
        assert occ.count == steps and max(occ.samples) <= 1.0

    def test_engine_spans_nest_dispatch_and_device(self):
        """Every prefill_into and decode_step span holds exactly one dispatch
        and one device child, the split PERF.md reads."""
        tracer, _, _, steps = self._serve()
        spans = sorted((e for e in tracer.events if e["ph"] == "X"), key=lambda e: e["ts"])
        for parent in ("prefill_into", "decode_step"):
            outer = [e for e in spans if e["name"] == parent]
            assert outer
            for o in outer:
                kids = [e["name"] for e in spans
                        if e["args"]["depth"] == o["args"]["depth"] + 1
                        and o["ts"] <= e["ts"] <= o["ts"] + o["dur"]]
                assert kids == ["dispatch", "device"]
        assert len([e for e in spans if e["name"] == "decode_step"]) == steps - 1


class TestRecordRequestMetrics:
    def _batcher(self, request_cls):
        class FakeBatcher:
            completed = [
                request_cls(0, np.zeros(2, np.int32), 2, generated=[1, 2], t_submit=0.0,
                            t_first=0.5, t_done=1.5),
                request_cls(1, np.zeros(2, np.int32), 1, generated=[3], truncated=True,
                            t_submit=1.0, t_first=1.2, t_done=1.2, agreement=[0.5],
                            abstained=True),
            ]
        return FakeBatcher()

    def test_folds_completed_ledger(self):
        from repro_torch.serve.batcher import Request

        reg = MetricsRegistry()
        record_request_metrics(reg, self._batcher(Request))
        assert reg.counter("serve_requests_completed_total").value == 2
        assert reg.counter("serve_tokens_total").value == 3
        assert reg.counter("serve_prompts_truncated_total").value == 1
        assert reg.counter("serve_abstain_total").value == 1
        assert reg.histogram("serve_ttft_seconds").samples == pytest.approx([0.5, 0.2])
        assert (reg.histogram("serve_request_latency_seconds").samples
                == pytest.approx([1.5, 0.2]))
        assert reg.histogram("serve_vote_agreement").samples == [0.5]

    def test_equals_the_reference_fold(self):
        from repro.serve.batcher import Request as JRequest
        from repro_torch.serve.batcher import Request

        mine, ref = MetricsRegistry(), j_metrics.MetricsRegistry()
        record_request_metrics(mine, self._batcher(Request))
        j_metrics.record_request_metrics(ref, self._batcher(JRequest))
        assert mine.to_prometheus() == ref.to_prometheus()
