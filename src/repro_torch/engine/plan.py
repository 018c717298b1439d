"""Execution-plan compiler: per-layer backend assignment.

``compile_plan(params, policy, mode)`` walks the parameter tree once, asks
every registered backend whether it can serve each leaf, and records for
every leaf the assigned backend, the reason and the eligibility map.
``ExecutionPlan.pack`` then turns master weights into the serving tree.

Leaves are visited in the reference's tree order (dict keys sorted, lists
in order), so ``index`` and ``path`` match its plan manifests.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Iterator

from repro_torch.core.binarize import BinarizeMode
from repro_torch.core.policy import XNOR_POLICY, is_conv_kernel, is_xnor_boundary
from repro_torch.engine import registry


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
    index: int
    shape: tuple[int, ...]
    backend: str
    reason: str
    eligible: dict[str, str]       # backend -> "ok" | why-not
    selected: bool                 # whether the weight policy selected the path
    xnor_selected: bool            # whether the xnor policy also selected it


@dataclasses.dataclass
class ExecutionPlan:
    """Explicit per-path backend assignment for one parameter tree."""

    mode: str                      # det | stoch | xnor
    layers: list[LayerAssignment]

    def assignments(self, backend: str | None = None) -> list[LayerAssignment]:
        return [a for a in self.layers if backend is None or a.backend == backend]

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
        weight_mode = (BinarizeMode.STOCHASTIC if self.mode == "stoch"
                       else BinarizeMode.DETERMINISTIC)
        pc = registry.PackContext(weight_mode=weight_mode, key=key)
        out = []
        for a, (path, leaf) in zip(self.layers, leaves):
            if path != a.path:
                raise ValueError(f"plan/params mismatch at leaf {a.index}: plan has "
                                 f"{a.path!r}, params has {path!r}")
            if tuple(leaf.shape) != a.shape:
                raise ValueError(f"plan/params shape mismatch at {a.path!r}: plan "
                                 f"has {a.shape}, params has {tuple(leaf.shape)}")
            lc = registry.LeafContext(
                path=a.path, index=a.index, shape=a.shape,
                is_conv=is_conv_kernel(a.path) and len(a.shape) == 4,
                selected=a.selected, xnor_selected=a.xnor_selected, mode=self.mode,
                xnor_boundary=is_xnor_boundary(a.path))
            out.append(registry.get_backend(a.backend).pack(lc, leaf, pc))
        return tree_unflatten(params, out)


_MODES = ("det", "stoch", "xnor")


def compile_plan(params: Any, policy, mode: str | BinarizeMode = "det", *,
                 xnor_policy=None) -> ExecutionPlan:
    """Assigns every leaf of ``params`` the highest-priority eligible
    backend under ``policy``/``mode`` and returns the explicit plan.

    ``mode="xnor"`` enables the fully-binary backends for leaves that
    ``xnor_policy`` (default ``core.policy.XNOR_POLICY``) also selects;
    weights still binarize by Eq. 1. Packed leaves always carry a
    per-channel scale (the reference's default ``with_scale=True``). A
    policy-selected leaf no binary backend can serve stays dense, with the
    reason in its row and a warning."""
    mode_str = mode.value if isinstance(mode, BinarizeMode) else str(mode)
    if mode_str not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode_str!r}")
    if xnor_policy is None:
        xnor_policy = XNOR_POLICY
    rows: list[LayerAssignment] = []
    for i, (path, leaf) in enumerate(tree_leaves_with_path(params)):
        shape = tuple(leaf.shape)
        lc = registry.LeafContext(
            path=path, index=i, shape=shape,
            is_conv=is_conv_kernel(path) and len(shape) == 4,
            selected=policy.selects(path),
            xnor_selected=mode_str == "xnor" and xnor_policy.selects(path),
            mode=mode_str, xnor_boundary=is_xnor_boundary(path))
        elig: dict[str, str] = {}
        chosen = None
        for spec in registry.backends("conv" if lc.is_conv else "linear"):
            ok, why = spec.eligible(lc)
            elig[spec.name] = "ok" if ok else why
            if ok and chosen is None:
                chosen = spec.name
        reason = _reason(lc, chosen, elig)
        if reason == "policy-excluded":
            pat = policy.excluded_by(path)
            if pat:
                reason = f"policy-excluded (pattern {pat!r})"
        rows.append(LayerAssignment(path=path, index=i, shape=shape, backend=chosen,
                                    reason=reason, eligible=elig, selected=lc.selected,
                                    xnor_selected=lc.xnor_selected))
    bad = [a for a in rows if a.reason.startswith("cannot pack")]
    if bad:
        warnings.warn(
            f"compile_plan: {len(bad)} policy-selected leaves cannot use a binary "
            f"backend and will serve dense -- "
            + "; ".join(f"{a.path}: {a.reason}" for a in bad[:8]),
            UserWarning, stacklevel=2)
    return ExecutionPlan(mode=mode_str, layers=rows)


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
