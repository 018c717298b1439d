"""The mesh-free part of the reference's ``distributed/sharding.py``: the
rules that give every plan row its sharding column.

A spec is a plain tuple standing in for ``jax.sharding.PartitionSpec``: one
entry per leading dim, each None (replicated), a mesh-axis name, or a tuple
of names. ``spec_to_json`` / ``spec_from_json`` convert to and from the
manifest's lists. Everything that takes a concrete mesh (sanitizing a spec,
placing a packed tree) waits for a mesh on the card (ROADMAP, queue 7).
"""
from __future__ import annotations

import functools
import re
from typing import Optional

Spec = tuple


# (path regex, function of ndim giving the spec); later rules win.
@functools.lru_cache(maxsize=None)
def _pspec_rules(fsdp: bool, dp_axes=("data",)):
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def rule(last_model_dim, fsdp_dim=None):
        def build(ndim: int) -> Spec:
            spec = [None] * ndim
            if last_model_dim is not None:
                spec[last_model_dim % ndim] = "model"
            if fsdp and fsdp_dim is not None and (fsdp_dim % ndim) != (
                    (last_model_dim or 0) % ndim if last_model_dim is not None else -99):
                spec[fsdp_dim % ndim] = dp
            return tuple(spec)
        return build

    return [
        (re.compile(r".*embed.*"), rule(-2, -1)),            # (V, D): vocab TP
        (re.compile(r".*lm_head.*"), rule(-1, -2)),          # (D, V): vocab TP
        (re.compile(r".*(scale|gamma|beta|bias|A_log|dt_bias|D)$"), rule(None)),
        (re.compile(r".*router.*"), rule(None, -2)),
        (re.compile(r".*w_qkv$"), rule(-1, -2)),             # (.., D, q+2kv): TP out
        (re.compile(r".*w_o$"), rule(-2, -1)),               # (.., q, D): TP in
        (re.compile(r".*w_(gate|up)$"), rule(-1, -2)),       # (.., D, F)
        (re.compile(r".*wi$"), rule(-1, -2)),
        (re.compile(r".*w_down$"), rule(-2, -1)),            # (.., F, D)
        (re.compile(r".*wo$"), rule(-2, -1)),
        (re.compile(r".*in_proj$"), rule(-1, -2)),           # ssm
        (re.compile(r".*out_proj$"), rule(-2, -1)),
        (re.compile(r".*conv$"), rule(-1)),                  # depthwise (w, d_inner)
    ]


def leaf_pspec(path: str, ndim: int, fsdp: bool = False, dp_axes=("data",)) -> Spec:
    """Megatron-style spec of one master-weight leaf from its '/'-joined
    path (later rules win): what the plan records for every leaf a binary
    backend does not claim."""
    chosen: Spec = ()
    for pat, build in _pspec_rules(bool(fsdp), tuple(dp_axes)):
        if pat.fullmatch(path):
            chosen = build(ndim) if ndim else ()
    return chosen[:ndim]


def tp_spec(tp_dim: int, ndim: int) -> Optional[Spec]:
    """"model" on one dim, for a backend's registered ``tp_dim`` (None when
    the leaf is not matmul-shaped)."""
    if ndim < 2:
        return None
    entries = [None] * ndim
    entries[tp_dim % ndim] = "model"
    return tuple(entries)


def backend_leaf_spec(path: str, master_ndim: int, backend_spec) -> Optional[Spec]:
    """Master-shape spec of a leaf owned by a registered backend.

    A backend with ``tp_contract_dim`` shards the contraction (word) dim of
    the row-parallel projections (those whose path rule puts "model" on the
    input dim: w_o, wo, w_down, out_proj); everything else takes the
    backend's out-channel ``tp_dim``. None when it declares neither (the
    dense path rules apply)."""
    cd = backend_spec.tp_contract_dim
    if cd is not None and master_ndim >= 2:
        mspec = leaf_pspec(path, master_ndim)
        entries = list(mspec) + [None] * (master_ndim - len(mspec))
        if entries[cd % master_ndim] == "model":
            return tp_spec(cd, master_ndim)
    if backend_spec.tp_dim is not None:
        return tp_spec(backend_spec.tp_dim, master_ndim)
    return None


def spec_to_json(spec: Spec) -> list:
    """Spec -> JSON-stable list (entries None | str | [str, ...]); inverse of
    :func:`spec_from_json`."""
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def spec_from_json(entries) -> Spec:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)
