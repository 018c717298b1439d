"""Layer-backend registry: the single place that knows every datapath.

A backend is one way to store and execute a projection leaf at serving
time. It registers a :class:`BackendSpec` with

* ``eligible(ctx)``  -- can this leaf run here, and if not, why not,
* ``pack(ctx, leaf, pack_ctx)`` -- master weight -> serving representation,
* ``apply(leaf, x)`` -- execute the layer on an input batch,
* ``cost(m, k, n, **kw)`` -- device bytes and op count of one (M, K) x (K, N)
  application (``engine.costs``; ``plan_report`` reads it),

plus the apply seams it serves (``kinds``: "linear" and/or "conv") and the
leaf class it produces, which is how ``apply_linear`` / ``apply_conv2d``
dispatch: the registry maps (kind, leaf type) to its spec, and plain
tensors (binarized-dense conv kernels included) to dense.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

#: Eligibility result: (ok, reason); reason is "ok" when eligible.
EligibilityFn = Callable[["LeafContext"], tuple[bool, str]]


@dataclasses.dataclass(frozen=True)
class LeafContext:
    """Static facts about one parameter-tree leaf."""

    path: str                 # '/'-joined tree path, e.g. "layers/1/kernel"
    index: int                # leaf position in tree order
    shape: tuple[int, ...]
    is_conv: bool             # 4-D conv-stack kernel (policy.is_conv_kernel)
    selected: bool            # weight policy selects this path
    xnor_selected: bool       # xnor (activation) policy also selects it
    mode: str                 # requested engine mode: det | stoch | xnor
    xnor_boundary: bool = False  # excluded because its input is real-valued

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclasses.dataclass(frozen=True)
class PackContext:
    """Per-``pack`` arguments shared by all leaves: the weight mode and the
    key stochastic binarization draws from."""

    weight_mode: Any          # BinarizeMode for the weight values
    key: Any = None           # core.prng.Key; each leaf folds in its index
    with_scale: bool = True   # packed leaves carry the per-channel mean |w|


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    kinds: tuple[str, ...]    # apply seams served: ("linear",) / ("conv",)
    priority: int             # higher wins among eligible backends
    leaf_type: Optional[type]  # serving leaf class; None = plain tensor
    eligible: EligibilityFn
    pack: Callable[[LeafContext, Any, PackContext], Any]
    apply: Callable[..., Any]
    # (m, k, n) -> {"bytes": ..., "ops": ...}; may take shape= / with_scale=
    # keywords (plan_report passes them when the signature has them)
    cost: Callable[..., dict]
    doc: str = ""
    # Master-weight dim the plan's sharding column puts on the "model" mesh
    # axis (negative: from the end). The bitpacked backends use -1, the
    # out-channel dim, so an int32 word never splits across devices. None:
    # the Megatron path rules (distributed.sharding.leaf_pspec) apply.
    tp_dim: Optional[int] = None
    # Contraction dim the backend may shard over "model" for row-parallel
    # projections (whole int32 words; one all-reduce of partial sums). Only
    # exact-accumulation backends set it: integer popcount sums all-reduce
    # bit-exactly, f32 partial sums would change the summation order.
    tp_contract_dim: Optional[int] = None
    # apply reads models.layers.SignWords (the activation's packed Eq.-1
    # signs), so the model may fuse the sign into the producer's K3
    takes_sign_words: bool = False
    # (ctx, master shape, pack_ctx, device) -> a packer whose put(l, w) takes
    # the leaf's (K, N) matrices one at a time (row-major over the leading
    # dims) and whose leaf() is what pack gives for the whole leaf, bit for
    # bit (ExecutionPlan.pack_drawn); None: the backend packs whole leaves
    # (xnor: no served hybrid, whose draws it would take, runs xnor)
    matrix_packer: Optional[Callable[..., Any]] = None


_REGISTRY: dict[str, BackendSpec] = {}
_LEAF_DISPATCH: dict[tuple[str, type], BackendSpec] = {}


def register_backend(spec: BackendSpec) -> BackendSpec:
    """Adds (or replaces) a backend. Returns the spec for chaining."""
    old = _REGISTRY.get(spec.name)
    if old is not None:
        for key in [k for k, v in _LEAF_DISPATCH.items() if v is old]:
            del _LEAF_DISPATCH[key]
    _REGISTRY[spec.name] = spec
    if spec.leaf_type is not None:
        for kind in spec.kinds:
            _LEAF_DISPATCH[(kind, spec.leaf_type)] = spec
    return spec


def unregister_backend(name: str) -> None:
    """Removes a backend and its leaf-dispatch entries (no-op if absent)."""
    old = _REGISTRY.pop(name, None)
    if old is not None:
        for key in [k for k, v in _LEAF_DISPATCH.items() if v is old]:
            del _LEAF_DISPATCH[key]


def get_backend(name: str) -> BackendSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}") from None


def backend_names() -> list[str]:
    return [s.name for s in backends()]


def backends(kind: str | None = None) -> list[BackendSpec]:
    """The registered backends serving ``kind`` (all if None), highest
    priority first."""
    specs = [s for s in _REGISTRY.values() if kind is None or kind in s.kinds]
    return sorted(specs, key=lambda s: -s.priority)


def backend_for_leaf(leaf: Any, kind: str) -> BackendSpec:
    """The backend that produced ``leaf`` for the ``kind`` seam; anything
    unregistered is dense."""
    spec = _LEAF_DISPATCH.get((kind, type(leaf)))
    return spec if spec is not None else _REGISTRY["dense"]


def serving_leaf_types() -> tuple[type, ...]:
    """Every leaf class some registered backend produces."""
    return tuple({s.leaf_type for s in _REGISTRY.values() if s.leaf_type is not None})


def spec_for_serving_leaf(leaf: Any) -> Optional[BackendSpec]:
    """The spec whose ``leaf_type`` produced ``leaf`` (None for plain
    tensors and unregistered types), whatever the kind."""
    for (_, t), spec in _LEAF_DISPATCH.items():
        if t is type(leaf):
            return spec
    return None


def apply_linear(w: Any, x: Any, rows: Any = None) -> Any:
    """x @ w through whichever backend produced ``w``; ``rows``, an MoE
    expert leaf's live rows per expert, goes to backends that take it."""
    spec = backend_for_leaf(w, "linear")
    return spec.apply(w, x) if rows is None else spec.apply(w, x, rows=rows)


def apply_conv2d(w: Any, x: Any, *, stride=(1, 1), padding="SAME") -> Any:
    """conv2d(x, w), NHWC/HWIO, through whichever backend produced ``w``."""
    return backend_for_leaf(w, "conv").apply(w, x, stride=stride, padding=padding)
