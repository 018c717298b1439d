"""Execution-plan compiler: per-layer backend assignment as a serializable
manifest.

``compile_plan(params, policy, mode)`` walks the parameter tree once, asks
every registered backend whether it can serve each leaf, and records for
every leaf the assigned backend, the reason, the eligibility map and the
sharding column. The :class:`ExecutionPlan`

* packs master weights into the serving tree (``plan.pack(params, key)``),
* saves to and loads from a JSON manifest (``save``/``load``) equal, byte
  for byte, to the reference's (``benchmarks/golden_plans``),
* takes per-layer overrides (``overrides={"conv/3": "binarized_dense"}``;
  a key matches a leaf path exactly or as a '/'-prefix),
* records each row's sharding column (the mesh placement of the master
  leaf: binary backends put "model" on the out-channel dim, dense leaves
  follow the Megatron path rules; ``distributed.sharding``), which no
  placement reads until the port has a mesh (ROADMAP, queue 7),
* feeds ``plan_report``, which costs every row under every eligible
  backend, and ``lint`` (``repro_torch.analysis``).

Leaves are visited in the reference's tree order (dict keys sorted, lists
in order), so ``index`` and ``path`` match its manifests. A policy-selected
leaf no binary backend can serve is assigned ``dense`` with the blocking
reason in its row, and ``compile_plan`` warns.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import warnings
from typing import Any, Iterator, Mapping, Optional

from repro_torch.core.binarize import BinarizeMode
from repro_torch.core.policy import XNOR_POLICY, is_conv_kernel, is_xnor_boundary
from repro_torch.distributed import sharding as SH
from repro_torch.engine import costs as C
from repro_torch.engine import registry
from repro_torch.models.layers import tree_from_paths
from repro_torch.obs.collectives import predict_row_collective

PLAN_VERSION = 3

#: Manifest versions ``from_json`` reads. v1 rows have no sharding column
#: (loaded as None); v2 manifests have no ``replica_axis`` (loaded as None).
_READABLE_VERSIONS = (1, 2, PLAN_VERSION)


def tree_leaves_with_path(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs: dict keys sorted, lists/tuples in order, any
    other node (a tensor or a serving leaf) is a leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from tree_leaves_with_path(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree shaped like ``tree`` whose leaves are taken, in
    :func:`tree_leaves_with_path` order, from ``leaves``."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return next(it)

    return rebuild(tree)


def tree_map(fn, tree: Any) -> Any:
    """Applies ``fn`` to every leaf, keeping the dict/list structure."""
    return tree_unflatten(tree, (fn(leaf) for _, leaf in tree_leaves_with_path(tree)))


@dataclasses.dataclass
class LayerAssignment:
    """One plan row: which backend serves the leaf at ``path`` and why."""

    path: str
    index: int                     # leaf position in tree order (PRNG fold)
    shape: tuple[int, ...]
    backend: str
    reason: str
    eligible: dict[str, str]       # backend -> "ok" | why-not
    # Mesh placement of the master leaf: one entry per dim, each None, an
    # axis name or a list of names. None on the whole row: a v1 manifest.
    sharding: Optional[list] = None

    def to_json(self) -> dict:
        return {"path": self.path, "index": self.index, "shape": list(self.shape),
                "backend": self.backend, "reason": self.reason,
                "eligible": dict(self.eligible), "sharding": self.sharding}

    @classmethod
    def from_json(cls, d: dict) -> "LayerAssignment":
        return cls(path=d["path"], index=int(d["index"]),
                   shape=tuple(int(s) for s in d["shape"]), backend=d["backend"],
                   reason=d["reason"], eligible=dict(d["eligible"]),
                   sharding=d.get("sharding"))


@dataclasses.dataclass
class ExecutionPlan:
    """Explicit per-path backend assignment for one parameter tree."""

    mode: str                      # det | stoch | xnor
    with_scale: bool
    layers: list[LayerAssignment]
    # Mesh axis an ensemble's replica dim (repro_torch.stoch) shards over:
    # "data", "model" or None (replicated). Rides the manifest (v3).
    replica_axis: Optional[str] = None
    version: int = PLAN_VERSION

    # -- queries ----------------------------------------------------------
    def __getitem__(self, path: str) -> LayerAssignment:
        for a in self.layers:
            if a.path == path:
                return a
        raise KeyError(path)

    def assignments(self, backend: str | None = None) -> list[LayerAssignment]:
        return [a for a in self.layers if backend is None or a.backend == backend]

    def fallthroughs(self) -> list[LayerAssignment]:
        """Policy-selected leaves that no binary backend could serve."""
        return [a for a in self.layers if a.reason.startswith("cannot pack")]

    def stochastic_rows(self) -> list[LayerAssignment]:
        """Rows whose pack transform draws from the key: the leaves
        ``stoch.sample_replicas`` draws anew for each replica. Empty unless
        the mode is "stoch" (det and xnor packs take no key)."""
        if self.mode != "stoch":
            return []
        return [a for a in self.layers if a.backend != "dense"]

    #: Leaf basenames that are elementwise parameters, not projections.
    _ELEMENTWISE = ("scale", "bias", "b", "beta", "gamma")

    def compute_rows(self) -> list[LayerAssignment]:
        """Rows that are matmul or conv applications (ndim >= 2): the ones
        whose sharding column implies collectives."""
        return [a for a in self.layers
                if len(a.shape) >= 2 and a.path.rsplit("/", 1)[-1] not in self._ELEMENTWISE]

    def sharding_axes(self) -> set[str]:
        """Every mesh-axis name the sharding columns and ``replica_axis``
        name."""
        axes: set[str] = set()
        for a in self.layers:
            for entry in a.sharding or ():
                if entry is None:
                    continue
                names = entry if isinstance(entry, (list, tuple)) else [entry]
                axes.update(n for n in names if n is not None)
        if self.replica_axis is not None:
            axes.add(self.replica_axis)
        return axes

    def lint(self, *, mesh_axes=None, axis_sizes=None):
        """Static checks of this manifest (``repro_torch.analysis.lint_plan``);
        a list of Findings, empty when clean."""
        from repro_torch.analysis import lint_plan

        return lint_plan(self, mesh_axes=mesh_axes, axis_sizes=axis_sizes)

    # -- packing ----------------------------------------------------------
    def _pack_context(self, key) -> registry.PackContext:
        return registry.PackContext(
            weight_mode=(BinarizeMode.STOCHASTIC if self.mode == "stoch"
                         else BinarizeMode.DETERMINISTIC),
            key=key, with_scale=self.with_scale)

    @staticmethod
    def _check_shape(a: LayerAssignment, shape, what: str) -> None:
        if tuple(shape) != a.shape:
            raise ValueError(f"plan/{what} shape mismatch at {a.path!r}: plan has "
                             f"{a.shape}, {what} has {tuple(shape)}")

    def pack(self, params: Any, key=None) -> Any:
        """Applies each row's backend ``pack`` transform to its leaf.

        ``key`` (``core.prng.key(seed)``) feeds the stochastic words: each
        leaf draws from ``key`` folded with its index, as the reference does,
        so the words equal the reference's at ``jax.random.key(seed)``;
        ``xnor`` plans binarize deterministically (Eq. 1). The tree must
        match the plan leaf for leaf (path and shape)."""
        leaves = list(tree_leaves_with_path(params))
        if len(leaves) != len(self.layers):
            raise ValueError(f"plan/params mismatch: plan has {len(self.layers)} "
                             f"leaves, params has {len(leaves)}")
        pc = self._pack_context(key)
        out = []
        for a, (path, leaf) in zip(self.layers, leaves):
            if path != a.path:
                raise ValueError(f"plan/params mismatch at leaf {a.index}: plan has "
                                 f"{a.path!r}, params has {path!r}")
            self._check_shape(a, leaf.shape, "params")
            out.append(registry.get_backend(a.backend).pack(
                _leaf_context(a, self.mode), leaf, pc))
        return tree_unflatten(params, out)

    def pack_drawn(self, draws, generator, key=None, *, device) -> Any:
        """:meth:`pack` of the masters that ``draws`` (a model's draw order,
        ``models.layers.LeafDraw``: ``models.transformer.lm_draws``) makes
        from ``generator``, without ever holding them all: the draws are
        walked in order, making the generator calls ``materialize`` makes,
        and each matrix of a leaf whose backend has a ``matrix_packer`` goes
        through it as it is drawn (the transient is one (K, N) matrix); any
        other leaf is drawn whole and packed as :meth:`pack` packs it. So the
        result equals ``pack(tree of materialized draws, key)`` leaf for
        leaf, bit for bit. The draws must cover the plan's rows (path and
        shape)."""
        rows = {a.path: a for a in self.layers}
        if sorted(d.path for d in draws) != sorted(rows):
            raise ValueError(f"plan/draws mismatch: plan has {sorted(rows)}, draws have "
                             f"{sorted(d.path for d in draws)}")
        pc = self._pack_context(key)
        out = {}
        for d in draws:
            a = rows[d.path]
            self._check_shape(a, d.shape, "draws")
            spec, lc = registry.get_backend(a.backend), _leaf_context(a, self.mode)
            if d.whole is None and spec.matrix_packer is not None:
                packer = spec.matrix_packer(lc, a.shape, pc, device)
                for i, w in enumerate(d.matrices(generator, device)):
                    packer.put(i, w)
                out[a.path] = packer.leaf()
            else:
                out[a.path] = spec.pack(lc, d.materialize(generator, device), pc)
        return tree_from_paths(out.items())

    # -- serialization ----------------------------------------------------
    def to_json(self) -> dict:
        return {"version": self.version, "mode": self.mode, "with_scale": self.with_scale,
                "replica_axis": self.replica_axis,
                "layers": [a.to_json() for a in self.layers]}

    @classmethod
    def from_json(cls, d: dict) -> "ExecutionPlan":
        if d.get("version") not in _READABLE_VERSIONS:
            raise ValueError(f"unsupported plan version {d.get('version')!r} "
                             f"(expected one of {_READABLE_VERSIONS})")
        return cls(mode=d["mode"], with_scale=bool(d["with_scale"]),
                   layers=[LayerAssignment.from_json(a) for a in d["layers"]],
                   replica_axis=d.get("replica_axis"), version=int(d["version"]))

    def save(self, path) -> str:
        """Writes the manifest as the reference does (``indent=1``, sorted
        keys, a trailing newline); returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return str(path)

    @classmethod
    def load(cls, path) -> "ExecutionPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _leaf_context(a: LayerAssignment, mode: str) -> registry.LeafContext:
    """The pack-time context of a plan row, compiled or loaded. The policy
    facts come from the recorded eligibility map, as in the reference: a
    backend reports "policy-excluded" iff the weight policy skipped the
    leaf, and the xnor-kind backend reports "ok" iff the activation policy
    selected it; ``xnor_boundary`` comes from the path. So a loaded plan
    packs, and through its leaf types routes, as a fresh compile does."""
    is_conv = len(a.shape) == 4 and "xnor_conv" in a.eligible
    policy_probe = a.eligible.get("binarized_dense" if is_conv else "packed",
                                  "policy-excluded")
    xnor_probe = a.eligible.get("xnor_conv" if is_conv else "xnor", "")
    return registry.LeafContext(
        path=a.path, index=a.index, shape=a.shape, is_conv=is_conv,
        selected="policy-excluded" not in policy_probe,
        xnor_selected=xnor_probe == "ok", mode=mode,
        xnor_boundary=is_xnor_boundary(a.path))


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

_MODES = ("det", "stoch", "xnor")


def _match_override(overrides: Mapping[str, str], path: str) -> tuple[str, str] | None:
    """Longest-prefix override lookup: a key matches ``path`` exactly or as a
    leading '/'-separated prefix (``conv/3`` matches ``conv/3/kernel``).
    Returns (pattern, backend) or None."""
    best, best_len = None, -1
    for pat, backend in overrides.items():
        if (path == pat or path.startswith(pat + "/")) and len(pat) > best_len:
            best, best_len = (pat, backend), len(pat)
    return best


def _row_sharding(path: str, shape: tuple, backend: str) -> list:
    """The sharding column of one row: binary backends shard their
    registered ``tp_dim`` (the out-channel dim, so a packed int32 word never
    splits across devices), or the contraction dim of row-parallel
    projections where the backend declares ``tp_contract_dim``; dense
    leaves follow the Megatron path rules. Mesh-independent axis names:
    checking them against a concrete mesh waits for ROADMAP queue 7."""
    ndim = len(shape)
    spec = SH.backend_leaf_spec(path, ndim, registry.get_backend(backend))
    if spec is None:
        spec = SH.leaf_pspec(path, ndim)
    return SH.spec_to_json(spec)


def compile_plan(params: Any, policy, mode: str | BinarizeMode = "det", *,
                 xnor_policy=None, with_scale: bool = True,
                 overrides: Optional[Mapping[str, str]] = None, mesh=None,
                 replica_axis: Optional[str] = None, warn: bool = True) -> ExecutionPlan:
    """Assigns every leaf of ``params`` the highest-priority eligible
    backend under ``policy``/``mode`` and returns the explicit plan.

    ``mode="xnor"`` enables the fully-binary backends for leaves that
    ``xnor_policy`` (default ``core.policy.XNOR_POLICY``) also selects;
    weights still binarize by Eq. 1. ``with_scale=False`` packs leaves
    without the per-channel scale. ``overrides`` forces paths (exact or
    '/'-prefix) onto a named backend, which must be eligible there (``dense``
    always is); an exact path that is not raises, and so does a pattern
    that matched no leaf. ``replica_axis`` is recorded for an ensemble
    (``stoch``). ``mesh`` raises ``NotImplementedError`` (queue 7)."""
    if mesh is not None:
        raise NotImplementedError(
            "compile_plan(mesh=...): the port has no device mesh yet; the sharding column "
            "is recorded mesh-independent (ROADMAP, queue 7)")
    mode_str = mode.value if isinstance(mode, BinarizeMode) else str(mode)
    if mode_str not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode_str!r}")
    if xnor_policy is None:
        xnor_policy = XNOR_POLICY
    rows: list[LayerAssignment] = []
    override_used = {pat: False for pat in (overrides or ())}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(params)):
        shape = tuple(int(d) for d in leaf.shape)
        lc = registry.LeafContext(
            path=path, index=i, shape=shape,
            is_conv=is_conv_kernel(path) and len(shape) == 4,
            selected=policy.selects(path),
            xnor_selected=mode_str == "xnor" and xnor_policy.selects(path),
            mode=mode_str, xnor_boundary=is_xnor_boundary(path))
        kind = "conv" if lc.is_conv else "linear"
        elig: dict[str, str] = {}
        chosen = None
        for spec in registry.backends(kind):
            ok, why = spec.eligible(lc)
            elig[spec.name] = "ok" if ok else why
            if ok and chosen is None:
                chosen = spec.name
        reason = _reason(lc, chosen, elig)
        if reason == "policy-excluded":
            pat = policy.excluded_by(path)
            if pat:
                reason = f"policy-excluded (pattern {pat!r})"
        if overrides:
            hit = _match_override(overrides, path)
            if hit is not None:
                pat, forced = hit
                spec = registry.get_backend(forced)      # raises on an unknown name
                if kind in spec.kinds and (forced == "dense" or elig.get(forced) == "ok"):
                    override_used[pat] = True
                    chosen, reason = forced, f"override ({chosen} -> {forced})"
                elif pat == path:
                    # an exact path validates strictly; a '/'-prefix (a whole
                    # layer: kernel, bias, bn) retargets only the leaves the
                    # backend can serve
                    why = (elig.get(forced) if kind in spec.kinds
                           else f"backend serves {spec.kinds}, leaf is {kind}")
                    raise ValueError(f"override {path!r} -> {forced!r}: ineligible ({why})")
        rows.append(LayerAssignment(path=path, index=i, shape=shape, backend=chosen,
                                    reason=reason, eligible=elig,
                                    sharding=_row_sharding(path, shape, chosen)))
    unused = [pat for pat, used in override_used.items() if not used]
    if unused:
        raise ValueError(f"overrides matched no applicable leaf: {unused} (paths are "
                         f"'/'-joined, e.g. 'conv/3' or 'conv/3/kernel')")
    plan = ExecutionPlan(mode=mode_str, with_scale=with_scale, layers=rows,
                         replica_axis=replica_axis)
    if warn:
        _warn_fallthroughs(plan)
    return plan


def _reason(lc: registry.LeafContext, chosen: str, elig: dict) -> str:
    """Why the leaf landed where it did; in particular why a
    policy-selected leaf did not land on a better backend."""
    if not lc.selected:
        return "policy-excluded"
    if chosen == "dense":
        blocker = elig.get("xnor_conv" if lc.is_conv else "packed", "")
        return f"cannot pack: {blocker}"
    if chosen == "binarized_dense":
        return ("no packed-weight conv lowering"
                if lc.mode != "xnor"
                else elig.get("xnor_conv", "xnor-policy-excluded"))
    if chosen == "packed" and lc.mode == "xnor":
        return elig.get("xnor", "xnor-policy-excluded")
    return "selected"


def _warn_fallthroughs(plan: ExecutionPlan) -> None:
    bad = plan.fallthroughs()
    if bad:
        details = "; ".join(f"{a.path}: {a.reason}" for a in bad[:8])
        more = "" if len(bad) <= 8 else f" (+{len(bad) - 8} more)"
        warnings.warn(f"compile_plan: {len(bad)} policy-selected leaves cannot use a "
                      f"binary backend and will serve dense — {details}{more}",
                      UserWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def _accepts_cost_kwargs(fn) -> bool:
    """Whether a backend's cost callable takes the ``shape``/``with_scale``
    keywords (read off its signature, never probed)."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):     # C callables and the like
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD or p.name in ("shape", "with_scale")
               for p in params)


def plan_report(plan: ExecutionPlan, *, batch: int = 8, full: bool = False,
                axis_sizes=None) -> list[dict]:
    """Costs every plan row under its backend and every eligible
    alternative, ``batch`` GEMM rows an application (for a conv, one row is
    one output position, so pass ``batch * OH * OW`` for per-image numbers;
    the ``weight_bytes`` columns do not depend on it). Each row also has the
    ``collectives`` its sharding column implies per application
    (``obs.collectives.predict_row_collective``; ``axis_sizes`` resolves the
    participant count). Rows that are untouched policy-excluded dense
    leaves are left out unless ``full``."""
    rows = []
    for a in plan.layers:
        if not full and a.backend == "dense" and a.reason.startswith("policy-excluded"):
            continue
        if len(a.shape) >= 2:
            if len(a.shape) == 4:
                kh, kw, c, n = a.shape
                k = kh * kw * c
            else:
                k, n = a.shape[-2], a.shape[-1]
        else:
            k = n = 0
        cost_by_backend = {}
        for name, status in a.eligible.items():
            if status == "ok" and k:
                fn = registry.get_backend(name).cost
                if _accepts_cost_kwargs(fn):
                    cost_by_backend[name] = fn(batch, k, n, shape=a.shape,
                                               with_scale=plan.with_scale)
                else:
                    cost_by_backend[name] = fn(batch, k, n)
        conv = len(a.shape) == 4
        rows.append({
            "path": a.path, "backend": a.backend, "reason": a.reason,
            "shape": list(a.shape), "k": k, "n": n,
            "weight_bytes_dense": C.dense_weight_bytes(a.shape) if a.shape else 0,
            "weight_bytes": (
                C.packed_weight_bytes(a.shape, conv=conv, with_scale=plan.with_scale,
                                      flat=a.backend == "packed_conv")
                if a.backend in ("packed", "xnor", "xnor_conv", "packed_conv")
                else C.dense_weight_bytes(a.shape) if a.shape else 0),
            "costs": cost_by_backend,
            "collectives": predict_row_collective(a.sharding, a.shape, batch=batch,
                                                  axis_sizes=axis_sizes),
        })
    return rows


def _fmt_collective(c: Optional[dict]) -> str:
    """Short cell of the plan table: 'all-gather@model 2.0KB/app'."""
    if not c:
        return "-"
    axes = "+".join(c["axes"])
    parts = f" x{c['parts']}" if c.get("parts") else ""
    return f"{c['kind']}@{axes}{parts} {c['bytes_per_app'] / 1e3:.1f}KB/app"


def format_plan_table(rows: list[dict]) -> str:
    """Aligned text table: path | backend | K x N | weight bytes (dense ->
    assigned) | collectives | reason."""
    hdr = ("path", "backend", "KxN", "w-bytes dense->plan", "collectives", "reason")
    table = [hdr]
    for r in rows:
        ratio = r["weight_bytes_dense"] / r["weight_bytes"] if r["weight_bytes"] else 1.0
        table.append((
            r["path"], r["backend"], f"{r['k']}x{r['n']}" if r["k"] else "-",
            f"{r['weight_bytes_dense']:,} -> {r['weight_bytes']:,} ({ratio:.1f}x)",
            _fmt_collective(r.get("collectives")), r["reason"]))
    widths = [max(len(row[i]) for row in table) for i in range(len(hdr))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip() for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
