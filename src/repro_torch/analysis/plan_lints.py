"""Static lints over :class:`repro_torch.engine.plan.ExecutionPlan`
manifests (a copy of the reference's ``analysis/plan_lints.py``, whose
findings these equal on the same manifest).

The rules check the invariants a sharded serve depends on, straight off
the manifest (any readable version, v1-v3; v1 rows have no sharding column
to lint):

``plan.dense_fallthrough``
    A policy-selected leaf silently serving dense because no binary
    backend could take it (``K % 32 != 0``, ndim < 2). ``compile_plan``
    warns; in CI a warning scrolls away — this makes it a gate.

``plan.word_lane_split``
    A sharding-column placement that would split a packed int32 word
    lane: non-batch mesh axes on a contraction/word dim of a packed
    backend that declares no ``tp_contract_dim`` (f32 accumulation order
    would change across devices), a conv kernel's folded kh/kw/C dims
    sharded at all, or a word split that does not divide into whole
    int32 words.

``plan.unknown_axis``
    A sharding entry (or the plan's ``replica_axis``) naming a mesh axis
    the target mesh does not have — placement would silently drop it.

``plan.replica_axis_collision``
    The ensemble ``replica_axis`` reused inside a stochastic row's own
    sharding column: placing the replicas would put the same mesh axis on
    two tensor dims.

``plan.boundary_reshard``
    A packed/dense boundary where the upstream row's output sharding
    cannot flow into the downstream row — GSPMD materializes a reshard
    (gather or copy) there. Informational.

All rules return :class:`repro_torch.analysis.findings.Finding` lists.
"""
from __future__ import annotations

from typing import (Any, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

from repro_torch.analysis.findings import ERROR, INFO, Finding
from repro_torch.engine import registry
from repro_torch.engine.plan import ExecutionPlan, LayerAssignment

#: Packed word width (bits per int32 lane group) — the invariant the
#: word-lane lint protects. Mirrors ``core.packing.PACK``.
WORD = 32

#: Mesh axes that carry batch (data) parallelism; sharding a weight dim
#: over them is FSDP-style and never implies a word-lane split concern
#: for the lint below (the packed word dim is only ever model-sharded).
BATCH_AXES = ("data", "pod")

#: Default axis vocabulary for linting mesh-independent manifests (the
#: checked-in goldens): every axis name the repo's placement rules emit.
DEFAULT_MESH_AXES = ("data", "model", "pod")


def _axes_at(sharding: Optional[list], dim: int) -> List[str]:
    """Axis names a sharding column places on ``dim`` (flattened)."""
    if sharding is None or dim >= len(sharding):
        return []
    entry = sharding[dim]
    if entry is None:
        return []
    names = entry if isinstance(entry, (list, tuple)) else [entry]
    return [a for a in names if a is not None]


def _all_axes(sharding: Optional[list]) -> Set[str]:
    out: Set[str] = set()
    for d in range(len(sharding or [])):
        out.update(_axes_at(sharding, d))
    return out


def _backend_spec(name: str) -> Optional[registry.BackendSpec]:
    try:
        return registry.get_backend(name)
    except KeyError:  # plan from a build with extra custom backends
        return None


def _is_packed(spec: Optional[registry.BackendSpec]) -> bool:
    """Whether a backend stores packed int32 word tensors (dense and
    binarized_dense keep plain arrays — no word lanes to protect)."""
    return spec is not None and spec.leaf_type is not None


def _parts(axes: Sequence[str],
           axis_sizes: Optional[Dict[str, int]]) -> Optional[int]:
    if axis_sizes is None:
        return None
    n = 1
    for a in axes:
        n *= int(axis_sizes.get(a, 1))
    return n


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def lint_dense_fallthrough(plan: ExecutionPlan) -> List[Finding]:
    """plan.dense_fallthrough — policy-selected leaves serving dense."""
    out = []
    for a in plan.fallthroughs():
        out.append(Finding(
            rule="plan.dense_fallthrough", severity=ERROR, where=a.path,
            message=(f"policy-selected leaf {a.path!r} {a.shape} serves "
                     f"dense ({a.reason})"),
            hint=("pad/resize the layer to K % 32 == 0, exclude the path "
                  "from the weight policy, or force an explicit backend "
                  "via overrides={...} and waive this rule"),
            data={"shape": list(a.shape), "reason": a.reason}))
    return out


def _lint_row_lanes(a: LayerAssignment,
                    spec: registry.BackendSpec,
                    axis_sizes: Optional[Dict[str, int]]) -> List[Finding]:
    ndim = len(a.shape)
    is_conv = "conv" in spec.kinds and ndim == 4
    out: List[Finding] = []
    for dim in range(ndim - 1):          # the out dim (tp_dim) is safe
        axes = [x for x in _axes_at(a.sharding, dim)
                if x not in BATCH_AXES]
        if not axes:
            continue
        if is_conv:
            # (kh, kw, C, N): dims 0..2 all fold into the packed word dim
            out.append(Finding(
                rule="plan.word_lane_split", severity=ERROR, where=a.path,
                message=(f"conv kernel dim {dim} of {a.shape} is sharded "
                         f"over {axes} but kh*kw*C folds into packed int32 "
                         f"words — a lane group would cross devices"),
                hint=("shard conv kernels only on the out-channel dim "
                      "(the backend's tp_dim)"),
                data={"dim": dim, "axes": axes, "backend": a.backend}))
            continue
        if dim != ndim - 2:
            continue                     # stacked-leaf leading dims: fine
        k = a.shape[dim]
        if spec.tp_contract_dim is None:
            out.append(Finding(
                rule="plan.word_lane_split", severity=ERROR, where=a.path,
                message=(f"contraction dim of {a.shape} is sharded over "
                         f"{axes} but backend {a.backend!r} declares no "
                         f"tp_contract_dim — partial f32 sums would change "
                         f"accumulation order (and the word dim would "
                         f"split mid-lane)"),
                hint=("move the split to the out-channel dim, or use an "
                      "exact-accumulation backend (integer popcount "
                      "all-reduce, e.g. 'xnor') for row-parallel rows"),
                data={"dim": dim, "axes": axes, "backend": a.backend}))
            continue
        parts = _parts(axes, axis_sizes)
        words, rem = divmod(k, WORD)
        if rem or (parts and parts > 1 and words % parts):
            out.append(Finding(
                rule="plan.word_lane_split", severity=ERROR, where=a.path,
                message=(f"row-parallel split of K={k} over {axes}"
                         f"{f' x{parts}' if parts else ''} does not "
                         f"divide into whole {WORD}-bit words per device"),
                hint=(f"keep K/{WORD} divisible by the model-axis size so "
                      f"every shard holds whole int32 words"),
                data={"dim": dim, "axes": axes, "k": k, "parts": parts}))
    return out


def lint_word_lane_split(plan: ExecutionPlan,
                         axis_sizes: Optional[Dict[str, int]] = None
                         ) -> List[Finding]:
    """plan.word_lane_split — placements that break a packed word lane."""
    out: List[Finding] = []
    for a in plan.layers:
        spec = _backend_spec(a.backend)
        if not _is_packed(spec) or len(a.shape) < 2 or a.sharding is None:
            continue
        out.extend(_lint_row_lanes(a, spec, axis_sizes))
    return out


def lint_unknown_axis(plan: ExecutionPlan,
                      mesh_axes: Optional[Iterable[str]] = None
                      ) -> List[Finding]:
    """plan.unknown_axis — sharding names an axis the mesh lacks."""
    known = set(mesh_axes if mesh_axes is not None else DEFAULT_MESH_AXES)
    out: List[Finding] = []
    for a in plan.layers:
        bad = sorted(_all_axes(a.sharding) - known)
        if bad:
            out.append(Finding(
                rule="plan.unknown_axis", severity=ERROR, where=a.path,
                message=(f"sharding column {a.sharding} names mesh "
                         f"axes {bad} the mesh does not have "
                         f"(known: {sorted(known)})"),
                hint=("fix the axis name, or compile the plan against the "
                      "concrete mesh so sanitize_spec drops it explicitly"),
                data={"axes": bad, "sharding": a.sharding}))
    if plan.replica_axis is not None and plan.replica_axis not in known:
        out.append(Finding(
            rule="plan.unknown_axis", severity=ERROR, where="<replica_axis>",
            message=(f"replica_axis {plan.replica_axis!r} is not a mesh "
                     f"axis (known: {sorted(known)})"),
            hint="pick a real mesh axis or None for replicated replicas",
            data={"replica_axis": plan.replica_axis}))
    return out


def lint_replica_collision(plan: ExecutionPlan) -> List[Finding]:
    """plan.replica_axis_collision — ensemble axis reused inside a
    stochastic row's own sharding column."""
    ax = plan.replica_axis
    if ax is None:
        return []
    out = []
    for a in plan.stochastic_rows():
        if ax in _all_axes(a.sharding):
            out.append(Finding(
                rule="plan.replica_axis_collision", severity=ERROR,
                where=a.path,
                message=(f"replica_axis {ax!r} also appears in the row's "
                         f"own sharding {a.sharding} — place_replicas "
                         f"would put one mesh axis on two tensor dims"),
                hint=("shard ensemble replicas over a different axis "
                      "(e.g. 'data'), or drop the axis from the row"),
                data={"replica_axis": ax, "sharding": a.sharding}))
    return out


def lint_boundary_reshard(plan: ExecutionPlan,
                          axis_sizes: Optional[Dict[str, int]] = None
                          ) -> List[Finding]:
    """plan.boundary_reshard — packed/dense boundaries predicted to
    materialize a reshard (informational; the measured audit decides)."""
    compute = plan.compute_rows()
    out: List[Finding] = []
    for prev, cur in zip(compute, compute[1:]):
        prev_spec, cur_spec = (_backend_spec(prev.backend),
                               _backend_spec(cur.backend))
        if _is_packed(prev_spec) == _is_packed(cur_spec):
            continue
        prev_out = [x for x in _axes_at(prev.sharding, len(prev.shape) - 1)
                    if x not in BATCH_AXES]
        if not prev_out:
            continue
        if _parts(prev_out, axis_sizes) == 1:
            continue                    # axis size 1: nothing to gather
        cur_in = _axes_at(cur.sharding, len(cur.shape) - 2)
        if cur_in == prev_out:
            continue                    # matched row-parallel consumer
        out.append(Finding(
            rule="plan.boundary_reshard", severity=INFO, where=cur.path,
            message=(f"packed/dense boundary {prev.path!r} "
                     f"({prev.backend}, out sharded {prev_out}) -> "
                     f"{cur.path!r} ({cur.backend}, contraction sharded "
                     f"{cur_in or 'replicated'}): GSPMD will reshard the "
                     f"activation here"),
            hint=("expected at datapath boundaries; confirm the cost in "
                  "the measured audit (launch.serve --audit-collectives)"),
            data={"producer": prev.path, "producer_out_axes": prev_out,
                  "consumer_in_axes": cur_in}))
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def lint_plan(plan: ExecutionPlan, *,
              mesh_axes: Optional[Iterable[str]] = None,
              axis_sizes: Optional[Dict[str, int]] = None) -> List[Finding]:
    """All plan lints over one manifest. ``mesh_axes`` is the axis
    vocabulary to validate names against (default: every axis the repo's
    placement rules emit); ``axis_sizes`` resolves participant counts
    (e.g. ``dict(zip(mesh.axis_names, mesh.devices.shape))``)."""
    findings: List[Finding] = []
    findings += lint_dense_fallthrough(plan)
    findings += lint_word_lane_split(plan, axis_sizes)
    findings += lint_unknown_axis(plan, mesh_axes)
    findings += lint_replica_collision(plan)
    findings += lint_boundary_reshard(plan, axis_sizes)
    return findings


def lint_plan_file(path: str,
                   **kw: Any) -> Tuple[ExecutionPlan, List[Finding]]:
    """Load a manifest from disk and lint it."""
    plan = ExecutionPlan.load(path)
    return plan, lint_plan(plan, **kw)
