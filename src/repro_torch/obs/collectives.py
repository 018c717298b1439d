"""The collective a plan row's sharding column implies, per application: the
static prediction column of ``plan_report`` (a copy of the reference's
``obs/collectives.py: predict_row_collective``). Counting the collectives a
compiled program really runs waits for a mesh on the card (ROADMAP,
queue 8).
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
