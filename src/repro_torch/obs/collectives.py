"""The collective a plan row's sharding column implies, per application: the
static prediction column of ``plan_report`` (a copy of the reference's
``obs/collectives.py: predict_row_collective``), and its sum over a model
call (:func:`predict_call_collectives`), which a mesh serve's counters
(``distributed.sharding.collective_counts``) equal. The reference's audit
of the collectives in a compiled program reads XLA's HLO, which the eager
port does not have (ROADMAP item 8).
"""
from __future__ import annotations

from typing import Optional

#: Activation bytes per element of the predicted column (``engine.costs``'s
#: convention: bf16 activations).
ACT_BYTES = 2


def predict_row_collective(sharding: Optional[list], shape: tuple, batch: int = 8,
                           axis_sizes: Optional[dict] = None) -> Optional[dict]:
    """What one row's sharding column implies per application:

    * non-batch mesh axes on the out-channel (last) dim, column parallelism:
      the output needs an **all-gather**;
    * non-batch axes on the contraction (second-to-last) dim, row
      parallelism: the partial sums need an **all-reduce**.

    ``bytes_per_app`` is the full output activation, ``batch * N *
    ACT_BYTES``. ``axis_sizes`` (e.g. ``{"model": 4}``) resolves the
    participant count; a row whose sharded axes all have size 1 gives None,
    as do unsharded and unannotated rows and rows sharded on batch axes only."""
    if not sharding or len(shape) < 2:
        return None
    batch_names = ("data", "pod")

    def model_axes(entry):
        names = entry if isinstance(entry, (list, tuple)) else [entry]
        return [a for a in names if a is not None and a not in batch_names]

    n = shape[-1]
    for dim, kind in ((len(shape) - 1, "all-gather"), (len(shape) - 2, "all-reduce")):
        if dim < len(sharding):
            axes = model_axes(sharding[dim])
            if axes:
                parts = None
                if axis_sizes is not None:
                    parts = 1
                    for a in axes:
                        parts *= int(axis_sizes.get(a, 1))
                    if parts <= 1:
                        return None
                return {"kind": kind, "axes": axes, "parts": parts,
                        "bytes_per_app": batch * n * ACT_BYTES}
    return None


def predict_call_collectives(plan, axis_sizes: dict, *, groups: int = 1) -> dict[str, int]:
    """{kind: count} of the collectives one model call (a prefill, a decode
    step or a prefill chunk) runs on a mesh of ``axis_sizes``: every
    compute row's :func:`predict_row_collective`, once per application (a
    stacked (L, K, N) row applies once a layer, any other row once: the
    embedding's lookup, the head's product), times ``groups``, the data
    groups that run the call. The port's single controller runs a
    group's model-axis collectives for that group alone, where one HLO op
    of the reference spans the groups as its replica groups."""
    out = {"all-gather": 0, "all-reduce": 0}
    for a in plan.compute_rows():
        c = predict_row_collective(a.sharding, a.shape, axis_sizes=axis_sizes)
        if c is not None:
            apps = 1
            for d in a.shape[:-2]:
                apps *= d
            out[c["kind"]] += apps * groups
    return out
