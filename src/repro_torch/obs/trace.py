"""Low-overhead step-level tracing for the serving stack (a copy of the
reference's ``repro/obs/trace.py``, with a CUDA fence).

A :class:`Tracer` records wall-clock spans through the ``ServeEngine`` entry
points and the ``stream_serve`` loop and exports them as Chrome trace-event
JSON: open the file at https://ui.perfetto.dev (or ``chrome://tracing``) and
the serving timeline reads like a flame chart.

Design constraints, in order:

* **Off means off.** ``tracer.span(...)`` on a disabled tracer returns one
  shared no-op context manager: no allocation, no clock read, no event.
  The serving hot loop pays a single attribute check per span site, and
  the device fence runs *only* while tracing (a dormant tracer never
  serialises the asynchronous launch queue).
* **Host vs device split.** A PyTorch call on a CUDA tensor returns once
  its kernels are queued; a wall-clock span around it measures only the
  host queueing them. When tracing, the engine brackets each entry point with a
  ``dispatch`` span (the call returns) and a ``device`` span
  (``tracer.fence`` = ``torch.cuda.synchronize``), so the trace separates
  Python overhead from the card's remaining work. Fencing serialises the
  queue, which can itself shift the numbers: the trace is for
  *attribution*, the untraced serve for *throughput*.
* **Valid Chrome trace events.** Every span is a complete event
  (``"ph": "X"``) with ``ts``/``dur`` in microseconds since the tracer's
  epoch, ``pid``/``tid``, and a ``depth`` arg (the span-stack depth at
  entry) that makes coverage accounting trivial; :func:`validate_trace`
  checks the schema, timestamp monotonicity, and span coverage, and is
  runnable as ``python -m repro_torch.obs trace.json``.

Span taxonomy, as the reference's: ``stream_serve`` (root) >
``init_decode`` / ``step`` > ``refill`` / ``prefill_into`` / ``sample`` /
``record`` / ``decode_step`` > ``dispatch`` / ``device``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch


def _cuda_devices(value) -> set:
    """The CUDA devices of the tensors in ``value`` (nested dicts, lists and
    tuples are searched)."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value)) if value else set()
    return set()


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records a complete ("X") event on exit."""

    __slots__ = ("tracer", "name", "args", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self.tracer
        tr._stack().pop()
        args = dict(self.args)
        args["depth"] = self.depth
        tr.events.append({
            "name": self.name, "ph": "X", "cat": "serve",
            "ts": (self.t0 - tr._t0) * 1e6,
            "dur": (t1 - self.t0) * 1e6,
            "pid": tr.pid, "tid": tr._tid(), "args": args,
        })
        return False


class Tracer:
    """Span recorder with Chrome trace-event export.

    ``enabled=False`` builds a dormant tracer: every ``span``/``instant``/
    ``fence`` call is a no-op (``span`` returns a shared null context
    manager — asserted in tests). ``fence=False`` keeps spans but never
    blocks on device values (dispatch-only timing)."""

    def __init__(self, enabled: bool = True, fence: bool = True,
                 pid: Optional[int] = None):
        self.enabled = enabled
        self.fence_enabled = fence
        self.events: list[dict] = []
        self.pid = os.getpid() if pid is None else pid
        self._t0 = time.perf_counter()
        self._tids: dict[int, int] = {}
        self._stacks: dict[int, list] = {}

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one serving phase; ``args`` land in the
        event's ``args`` dict (small JSON-able values only)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (request submitted, slot refilled, ...)."""
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "i", "s": "t", "cat": "serve",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": self.pid, "tid": self._tid(), "args": args,
        })

    def fence(self, value):
        """Waits for the card to finish the work queued so far on the CUDA
        device of each tensor in ``value`` (a tensor, or a dict, list or
        tuple holding tensors) — but only while tracing, so a dormant tracer
        never serialises the launch queue. CPU tensors pass through."""
        if self.enabled and self.fence_enabled:
            for dev in _cuda_devices(value):
                torch.cuda.synchronize(dev)
        return value

    # -- bookkeeping -------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        if ident not in self._tids:
            self._tids[ident] = len(self._tids) + 1
        return self._tids[ident]

    def _stack(self) -> list:
        ident = threading.get_ident()
        if ident not in self._stacks:
            self._stacks[ident] = []
        return self._stacks[ident]

    # -- export ------------------------------------------------------------
    def to_json(self) -> dict:
        """Chrome trace-event JSON object (events sorted by timestamp)."""
        events = sorted(self.events, key=lambda e: e["ts"])
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": "repro_torch.serve"},
        }]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
            f.write("\n")
        return path


#: Module-level disabled tracer: the default everywhere tracing is optional.
NULL_TRACER = Tracer(enabled=False)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

_REQUIRED_X = ("name", "ph", "ts", "dur", "pid", "tid")


def validate_trace(trace: dict | str) -> dict:
    """Validates a Chrome trace-event JSON object (or a path to one).

    Checks: the ``traceEvents`` envelope; required fields per complete
    ("X") event (``name``/``ph``/``ts``/``dur``/``pid``/``tid``);
    non-negative durations; timestamps monotonically non-decreasing in file
    order (the export sorts). Also computes *span coverage*: the fraction
    of the root span's duration covered by its depth-1 children — the
    acceptance bar for serving traces is >= 0.95 (everything the loop does
    should be inside a named phase).

    Returns ``{"events": n, "spans": n, "coverage": float|None,
    "root": name|None}``; raises ``ValueError`` on any schema violation.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    last_ts = None
    for e in events:
        if e.get("ph") == "M":
            continue
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                raise ValueError(f"event missing {k!r}: {e}")
        if last_ts is not None and e["ts"] < last_ts:
            raise ValueError(
                f"timestamps not monotonic: {e['ts']} after {last_ts}")
        last_ts = e["ts"]
    for e in spans:
        for k in _REQUIRED_X:
            if k not in e:
                raise ValueError(f"complete event missing {k!r}: {e}")
        if e["dur"] < 0:
            raise ValueError(f"negative duration: {e}")
    coverage = root_name = None
    roots = [e for e in spans if e.get("args", {}).get("depth") == 0]
    if roots:
        root = max(roots, key=lambda e: e["dur"])
        root_name = root["name"]
        inside = [e for e in spans
                  if e.get("args", {}).get("depth") == 1
                  and e["tid"] == root["tid"]
                  and root["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1.0]
        covered = sum(e["dur"] for e in inside)
        coverage = min(1.0, covered / root["dur"]) if root["dur"] > 0 else 1.0
    return {"events": len(events), "spans": len(spans),
            "coverage": coverage, "root": root_name}


def main() -> None:
    """CLI: ``python -m repro_torch.obs trace.json [--min-coverage 0.95]``
    — exits non-zero on schema violations or insufficient span coverage."""
    import argparse

    ap = argparse.ArgumentParser(description=validate_trace.__doc__)
    ap.add_argument("trace", help="Chrome trace-event JSON file")
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="fail unless depth-1 spans cover at least this "
                         "fraction of the root span")
    args = ap.parse_args()
    info = validate_trace(args.trace)
    cov = ("n/a" if info["coverage"] is None
           else f"{info['coverage'] * 100:.1f}%")
    print(f"{args.trace}: valid — {info['events']} events, "
          f"{info['spans']} spans, root={info['root']!r}, coverage={cov}")
    if args.min_coverage is not None:
        if info["coverage"] is None or info["coverage"] < args.min_coverage:
            raise SystemExit(
                f"span coverage {cov} below required "
                f"{args.min_coverage * 100:.0f}%")


if __name__ == "__main__":
    main()
