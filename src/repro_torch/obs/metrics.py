"""Process-local serving metrics: counters, gauges, histograms.

A copy of the reference's ``repro/obs/metrics.py`` (numpy only). One
:class:`MetricsRegistry` per serving process collects tok/s, TTFT, per-step
latency, queue depth, slot occupancy, and (under K-replica ensemble
serving) abstain counts and vote agreement, and exports them two ways:

* ``to_json()`` — lossless (histograms keep their samples), round-trips
  through ``MetricsRegistry.from_json`` so benchmark records and CI
  artifacts can be re-aggregated offline;
* ``to_prometheus()`` — Prometheus text exposition (counters/gauges as-is,
  histograms as summaries with p50/p95/p99 quantile lines) for scraping.

Histogram percentiles use numpy's default linear interpolation, asserted
against ``np.quantile`` in tests. Histograms keep raw samples (serving
runs observe thousands of points, not millions); a bounded reservoir can
ride behind the same API if a workload ever needs it.

Metric name conventions, as the reference's: serving metrics are prefixed
``serve_``, counters end in ``_total``, and units ride the name
(``_seconds``, ``_tokens``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Counter:
    """Monotonically increasing count (tokens emitted, steps run, ...)."""

    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        self.value += v

    def to_json(self) -> dict:
        return {"type": "counter", "help": self.help, "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-observed value (current queue depth, slot occupancy, ...)."""

    name: str
    help: str = ""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self) -> dict:
        return {"type": "gauge", "help": self.help, "value": self.value}


@dataclasses.dataclass
class Histogram:
    """Sample-keeping histogram with numpy-quantile percentiles."""

    name: str
    help: str = ""
    samples: list = dataclasses.field(default_factory=list)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(np.sum(self.samples)) if self.samples else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]; linear interpolation, matching np.quantile."""
        if not self.samples:
            return None
        return float(np.quantile(np.asarray(self.samples), q / 100.0))

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        a = np.asarray(self.samples)
        return {"count": int(a.size), "sum": float(a.sum()),
                "min": float(a.min()), "max": float(a.max()),
                "mean": float(a.mean()),
                "p50": float(np.quantile(a, 0.50)),
                "p95": float(np.quantile(a, 0.95)),
                "p99": float(np.quantile(a, 0.99))}

    def to_json(self) -> dict:
        return {"type": "histogram", "help": self.help,
                "summary": self.summary(), "samples": list(self.samples)}


class MetricsRegistry:
    """Name-keyed registry; ``counter``/``gauge``/``histogram`` get-or-
    create (re-registering a name as a different type raises)."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, help=help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- export ------------------------------------------------------------
    def to_json(self) -> dict:
        return {name: self._metrics[name].to_json()
                for name in sorted(self._metrics)}

    @classmethod
    def from_json(cls, d: dict) -> "MetricsRegistry":
        """Inverse of ``to_json`` (histogram samples restored verbatim)."""
        reg = cls()
        for name, m in d.items():
            kind = m.get("type")
            if kind == "counter":
                reg.counter(name, m.get("help", "")).value = float(m["value"])
            elif kind == "gauge":
                reg.gauge(name, m.get("help", "")).set(m["value"])
            elif kind == "histogram":
                h = reg.histogram(name, m.get("help", ""))
                h.samples.extend(float(s) for s in m.get("samples", ()))
            else:
                raise ValueError(f"unknown metric type {kind!r} for {name!r}")
        return reg

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition; histograms as summaries (quantile
        labels) since the registry keeps samples, not fixed buckets."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value:g}")
            else:
                lines.append(f"# TYPE {name} summary")
                for q in (0.5, 0.95, 0.99):
                    v = m.percentile(q * 100)
                    if v is not None:
                        lines.append(f'{name}{{quantile="{q}"}} {v:g}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"

    def format_table(self) -> str:
        """Human-readable one-line-per-metric summary for CLI output."""
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                s = m.summary()
                if s["count"]:
                    out.append(
                        f"{name}: n={s['count']} mean={s['mean']:.4g} "
                        f"p50={s['p50']:.4g} p95={s['p95']:.4g} "
                        f"p99={s['p99']:.4g}")
                else:
                    out.append(f"{name}: n=0")
            else:
                out.append(f"{name}: {m.value:g}")
        return "\n".join(out)


def record_request_metrics(registry: MetricsRegistry, batcher) -> None:
    """Fold a ``SlotBatcher``'s completed-request ledger into the registry:
    TTFT / end-to-end latency histograms, token and completion counters,
    and — when the ensemble columns are populated — per-token vote
    agreement and the abstain counter. Called by ``stream_serve`` at loop
    exit; callers aggregating several runs can call it per batcher."""
    ttft = registry.histogram("serve_ttft_seconds",
                              "submit-to-first-token seconds (queue incl.)")
    lat = registry.histogram("serve_request_latency_seconds",
                             "submit-to-last-token seconds (queue incl.)")
    done = registry.counter("serve_requests_completed_total",
                            "requests fully served")
    toks = registry.counter("serve_tokens_total", "tokens recorded")
    trunc = registry.counter("serve_prompts_truncated_total",
                             "prompts truncated to the slot width")
    for r in batcher.completed:
        if r.ttft is not None:
            ttft.observe(r.ttft)
        if r.latency is not None:
            lat.observe(r.latency)
        done.inc()
        toks.inc(len(r.generated))
        if r.truncated:
            trunc.inc()
        if r.agreement:
            agr = registry.histogram(
                "serve_vote_agreement",
                "per-token ensemble replica vote agreement (0-1)")
            for a in r.agreement:
                agr.observe(a)
        if r.abstained:
            registry.counter("serve_abstain_total",
                             "requests flagged below the abstain "
                             "threshold").inc()
