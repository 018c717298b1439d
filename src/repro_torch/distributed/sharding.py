"""Sharding rules and mesh placement (the reference's
``distributed/sharding.py``): the rules that give every plan row its
sharding column, a device mesh, the placement of a serving tree on it, and
the explicit collectives of mesh serving.

A spec is a plain tuple standing in for ``jax.sharding.PartitionSpec``: one
entry per leading dim, each None (replicated), a mesh-axis name, or a tuple
of names. ``spec_to_json`` / ``spec_from_json`` convert to and from the
manifest's lists.

Mesh serving is single-controller, as the reference's is: one process
drives every position of a ``("data", "model")`` :class:`Mesh`, where the
reference's GSPMD inserts the collectives and the port runs them itself,
in a fixed order, following the reference's serving layout
(``ShardCtx(decode=True)``):

* **column parallel**: a leaf with "model" on its out-channel dim (every
  ``packed`` projection, the ``xnor`` ones whose path rule is not
  row-parallel, and a dense tree's column projections) runs its product on
  each model position's N shard; the outputs are gathered (concatenated in
  position order on the group's lead position: one **all-gather**);
* **row parallel**: an ``xnor`` w_o / wo / w_down (``tp_contract_dim``) or
  a dense tree's row projection has "model" on its contraction dim. Each
  position takes its range of the activation and its words; an xnor
  position computes the int32 popcount dot of its range with no scale, the
  partials are summed (one **all-reduce**, exact in integers) and the scale
  is applied once after the sum (``engine.backends.row_partial`` /
  ``row_finish``). A 32-bit lane group is never split: a word dim shards
  only in whole words;
* **embedding**: vocab-parallel, a masked local take on each V shard and a
  sum (one all-reduce, exact: every element is one shard's row plus zeros);
* **head**: vocab-parallel on V, the logits gathered after the head product;
* attention internals, norms, the MLP hidden and the decode cache of a
  group's slots are replicated over "model": computed once, on the group's
  lead position.

The slots of a decode cache split over the batch axes ("pod", "data") as
``models.transformer.cache_pspecs`` says; each data group runs the model on
its own slots (``serve.engine.ServeEngine(mesh=)``). Every collective adds
one to its function's ``count`` (``all_gather.count``,
``all_reduce.count``), once for each data group that runs it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Spec = tuple
MODEL = "model"
#: The batch (data-parallel) axes a serving mesh may name, outermost first.
BATCH_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A grid of positions with named axes, e.g. ``Mesh((2, 2), ("data",
    "model"))``. ``devices`` is an object array shaped like the mesh holding
    each position's ``torch.device``: position p (row-major) sits on
    ``cuda:(p mod n_cards)``, so on a one-card machine every position sits
    on ``cuda:0`` (each with its own shard tensors), and ``device="cpu"``
    puts every position on the CPU. Asking for CUDA where torch sees no card
    raises; there is no fallback."""

    def __init__(self, shape, axis_names, *, device="cuda"):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} has {len(shape)} axes, names "
                             f"{axis_names} have {len(axis_names)}")
        if len(set(axis_names)) != len(axis_names) or not all(s >= 1 for s in shape):
            raise ValueError(f"mesh axes must be distinct and sizes >= 1, got "
                             f"{dict(zip(axis_names, shape))}")
        dev = torch.device(device)
        size = math.prod(shape)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"a mesh on {device!r} asked for, but torch sees no CUDA "
                                   f"device (pass device='cpu' for a CPU mesh)")
            n_cards = torch.cuda.device_count()
            devs = [torch.device("cuda", p % n_cards) for p in range(size)]
        elif dev.type == "cpu":
            devs = [torch.device("cpu")] * size
        else:
            raise ValueError(f"a mesh sits on 'cuda' or 'cpu', not {device!r}")
        self.axis_names = axis_names
        self.devices = np.empty(shape, dtype=object)
        for p, d in enumerate(devs):
            self.devices.flat[p] = d

    @property
    def shape(self) -> tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def model_size(self) -> int:
        return self.axis_sizes().get(MODEL, 1)

    def groups(self) -> np.ndarray:
        """(groups, model) int array of flat position indices: row g holds
        data group g's positions in model order (the groups row-major over
        every axis but "model")."""
        flat = np.arange(self.size).reshape(self.shape)
        if MODEL in self.axis_names:
            flat = np.moveaxis(flat, self.axis_names.index(MODEL), -1)
        return flat.reshape(-1, self.model_size)

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.axis_sizes()}, devices={devs})"


def batch_axes(mesh: Optional[Mesh]) -> tuple:
    """The data-parallel axes of ``mesh`` ("pod", "data"), outermost first."""
    if mesh is None:
        return ("data",)
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# parameter specs, from tree paths by pattern rules
# ---------------------------------------------------------------------------

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


def params_pspecs(params, fsdp: bool = False, dp_axes=("data",)):
    """A tree of specs shaped like ``params``, each leaf's by
    :func:`leaf_pspec` (``dp_axes``: the axes FSDP shards over)."""
    from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten

    return tree_unflatten(params, [leaf_pspec(path, leaf.ndim, fsdp=fsdp, dp_axes=dp_axes)
                                   for path, leaf in tree_leaves_with_path(params)])


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


def serving_leaf_pspec(path: str, leaf) -> Spec:
    """Master-shape spec of one serving-tree leaf without a plan: a leaf
    whose backend declares ``tp_dim`` / ``tp_contract_dim`` takes
    :func:`backend_leaf_spec` (the rules the plan compiler records); a
    plain 4-D conv kernel shards its out-channel dim; everything else
    follows the path rules (:func:`leaf_pspec`)."""
    from repro_torch.core.policy import is_conv_kernel
    from repro_torch.engine import registry

    spec = registry.spec_for_serving_leaf(leaf)
    if spec is not None:
        shape = getattr(leaf, "master_shape", getattr(leaf, "shape", ()))
        s = backend_leaf_spec(path, len(shape), spec)
        if s is not None:
            return s
    elif is_conv_kernel(path) and getattr(leaf, "ndim", 0) == 4:
        return tp_spec(-1, 4)
    return leaf_pspec(path, getattr(leaf, "ndim", 0))


def spec_to_json(spec: Spec) -> list:
    """Spec -> JSON-stable list (entries None | str | [str, ...]); inverse of
    :func:`spec_from_json`."""
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def spec_from_json(entries) -> Spec:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def entry_axes(entry) -> list[str]:
    """The axis names of one spec entry (None, a name, or a tuple of names)."""
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    return [a for a in names if a is not None]


def sanitize_spec(mesh, spec: Spec, shape) -> Spec:
    """Drops what a concrete mesh cannot honour: axis names the mesh lacks,
    dims not divisible by their axes' sizes (those dims replicate) and
    entries past the array's rank. Reads only ``mesh.axis_names`` and
    ``mesh.devices.shape``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for i, e in enumerate(spec):
        if i >= len(shape):
            break
        axes = [a for a in entry_axes(e) if a in sizes]
        n = math.prod(sizes[a] for a in axes)
        if not axes or shape[i] % n != 0:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return tuple(out)


def _adapt_spec(spec: Spec, ndim: int) -> Spec:
    """Fits a master-shape spec onto an array of rank ``ndim`` by dropping
    the second-to-last entry per excess rank (a PackedLinear's scale drops
    the K dim, keeping (stack..., N); an XnorConv's words collapse (kh, kw,
    C, N) to 2-D): the out-channel dim is last in every layout, so an
    out-channel "model" stays on N and a row-parallel contraction "model"
    never lands on a stack or scale dim."""
    entries = list(spec)
    while len(entries) > max(ndim, 1):
        entries.pop(-2)
    return tuple(entries) if ndim else ()


def divisibility_report(cfg, n_model: int = 16) -> dict:
    """Which dims shard cleanly over a model axis of ``n_model``."""
    return {
        "d_ff": cfg.d_ff % n_model == 0 if cfg.d_ff else True,
        "q_dim": cfg.q_dim % n_model == 0 if cfg.has_attention else True,
        "kv_dim": cfg.kv_dim % n_model == 0 if cfg.has_attention else True,
        "d_inner": (cfg.d_inner % n_model == 0) if cfg.ssm_state else True,
        "experts": (cfg.n_experts % n_model == 0) if cfg.n_experts else True,
        "vocab": cfg.vocab_size % n_model == 0,
    }


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _shard_index(mesh: Mesh, entry, p: int) -> int:
    """Which of its entry's shards position ``p`` holds: row-major over the
    entry's axes."""
    idx = dict(zip(mesh.axis_names, np.unravel_index(p, mesh.shape)))
    sizes = mesh.axis_sizes()
    i = 0
    for x in entry_axes(entry):
        i = i * sizes[x] + int(idx[x])
    return i


def _shard(a: torch.Tensor, mesh: Mesh, spec: Spec, p: int) -> torch.Tensor:
    """Position ``p``'s shard of ``a`` under ``spec`` (a sanitized spec of
    ``a``'s rank), copied to the position's device."""
    sizes = mesh.axis_sizes()
    out = a
    for d, e in enumerate(spec):
        if entry_axes(e):
            step = a.shape[d] // math.prod(sizes[x] for x in entry_axes(e))
            out = out.narrow(d, _shard_index(mesh, e, p) * step, step)
    dev = mesh.devices.flat[p]
    return torch.empty(out.shape, dtype=out.dtype, device=dev).copy_(out)


@dataclasses.dataclass
class Placed:
    """A leaf placed on a mesh: ``local`` is an object array shaped like
    the mesh holding each position's own shard (a tensor or a serving leaf),
    ``spec`` the master-shape spec they were cut by."""

    mesh: Mesh
    spec: Spec
    local: np.ndarray

    def position_nbytes(self) -> np.ndarray:
        """Bytes each position stores, shaped like the mesh."""
        out = np.zeros(self.mesh.shape, dtype=np.int64)
        for p in range(self.mesh.size):
            v = self.local.flat[p]
            out.flat[p] = (v.nbytes() if hasattr(v, "nbytes") and callable(v.nbytes)
                           else v.numel() * v.element_size())
        return out

    def model_dim(self) -> Optional[int]:
        """The (negative) master dim "model" splits, or None."""
        hit = [d - len(self.spec) for d, e in enumerate(self.spec) if MODEL in entry_axes(e)]
        if len(hit) > 1:
            raise NotImplementedError(f"a spec with 'model' on two dims: {self.spec}")
        return hit[0] if hit else None

    def _one_copy(self) -> list:
        """The shards of one data group (group 0), in model order."""
        return [self.local.flat[p] for p in self.mesh.groups()[0]]


@dataclasses.dataclass
class PlacedLeaf(Placed):
    """A serving leaf (``PackedLinear``, ``XnorLinear``, ...) placed on a
    mesh. ``master_shape`` and ``nbytes()`` (words and scales of one copy
    of the whole leaf) read as the unplaced leaf's do, so the plan report
    and ``packed_param_bytes`` still read it."""

    master_shape: tuple = ()

    def nbytes(self) -> int:
        parts, dim = self._one_copy(), self.model_dim()
        if dim is None:
            return parts[0].nbytes()
        out = sum(v.packed.numel() for v in parts) * 4
        scales = [v.scale.numel() for v in parts if v.scale is not None]
        if scales:      # an N split splits the scale; a K split replicates it
            out += (sum(scales) if dim == -1 else scales[0]) * 4
        return out


@dataclasses.dataclass
class PlacedTensor(Placed):
    """A plain tensor (a dense leaf) placed on a mesh."""

    shape: tuple = ()

    def numel(self) -> int:
        return math.prod(self.shape)


def _place_node(mesh: Mesh, spec: Spec, node):
    """Places one plan row's node under its master-shape spec, each stored
    array under the spec adapted to its rank and sanitized again (a word
    dim may not divide where its master dim did). A serving leaf's
    effective spec is its words': where they cannot split, the whole leaf
    replicates."""
    if isinstance(node, torch.Tensor):
        s = sanitize_spec(mesh, _adapt_spec(spec, node.ndim), node.shape)
        local = np.empty(mesh.shape, dtype=object)
        for p in range(mesh.size):
            local.flat[p] = _shard(node, mesh, s, p)
        return PlacedTensor(mesh, s, local, shape=tuple(node.shape))
    words = node.packed
    eff = sanitize_spec(mesh, _adapt_spec(spec, words.ndim), words.shape)
    tensors = {f.name: getattr(node, f.name) for f in dataclasses.fields(node)
               if isinstance(getattr(node, f.name), torch.Tensor)}
    row = len(eff) >= 2 and MODEL in entry_axes(eff[-2])
    local = np.empty(mesh.shape, dtype=object)
    for p in range(mesh.size):
        kw = {}
        for name, a in tensors.items():
            s = sanitize_spec(mesh, _adapt_spec(eff, a.ndim), a.shape)
            kw[name] = _shard(a, mesh, s, p)
        if row:
            # a row-parallel shard is a leaf of its own word range: its k
            # counts the real bits of that range
            w_per = words.shape[-2] // math.prod(mesh.axis_sizes()[x]
                                                 for x in entry_axes(eff[-2]))
            i = _shard_index(mesh, eff[-2], p)
            kw["k"] = min(node.k, (i + 1) * w_per * 32) - i * w_per * 32
        local.flat[p] = dataclasses.replace(node, **kw)
    return PlacedLeaf(mesh, eff, local, master_shape=tuple(node.master_shape))


def place_packed_params(mesh: Mesh, params, plan=None):
    """Places a (possibly packed) parameter tree on ``mesh``: every leaf
    becomes a :class:`Placed` holding one shard per mesh position.

    With ``plan`` (the compiled ``ExecutionPlan`` the tree was packed with)
    each leaf follows its row's sharding column; without one, or for a v1
    manifest's rows, the spec is re-derived from the leaf's type and path
    (:func:`serving_leaf_pspec`, the same rules). Packed words shard on the
    out-channel dim over "model", or on the word dim in whole words for a
    row-parallel xnor projection; scales follow their N dim; dense leaves
    follow the Megatron rules. Axes the mesh lacks and dims that do not
    divide replicate (:func:`sanitize_spec`)."""
    from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten

    nodes = list(tree_leaves_with_path(params))
    row_spec = {}
    if plan is not None:
        if len(plan.layers) != len(nodes):
            raise ValueError(f"plan/params mismatch: plan has {len(plan.layers)} rows, "
                             f"tree has {len(nodes)} leaves")
        row_spec = {a.path: a.sharding for a in plan.layers}
    out = []
    for path, node in nodes:
        if plan is not None and path not in row_spec:
            raise ValueError(f"plan/params mismatch: tree leaf {path!r} has no plan row "
                             f"(the plan was compiled for a different tree)")
        col = row_spec.get(path)
        spec = spec_from_json(col) if col is not None else serving_leaf_pspec(path, node)
        shape = getattr(node, "master_shape", getattr(node, "shape", ()))
        out.append(_place_node(mesh, sanitize_spec(mesh, spec, shape), node))
    return tree_unflatten(params, out)


def position_nbytes(placed) -> np.ndarray:
    """Bytes each mesh position stores of a placed tree, shaped like the
    mesh."""
    from repro_torch.engine.plan import tree_leaves_with_path

    total = None
    for _, leaf in tree_leaves_with_path(placed):
        b = leaf.position_nbytes()
        total = b if total is None else total + b
    return total


# ---------------------------------------------------------------------------
# a data group's view, and the collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModelShards:
    """One data group's view of a leaf split over "model": its shards in
    model-position order, split on master dim ``dim`` (-1: the out-channel
    or vocab dim; -2: the contraction or vocab rows). ``leaf[i]`` slices
    every shard's stacked dim, as a stacked leaf does."""

    parts: list
    dim: int

    def __getitem__(self, i):
        return ModelShards([p[i] for p in self.parts], self.dim)


def group_view(placed, g: int):
    """Data group ``g``'s view of a placed tree: a leaf that "model" splits
    becomes :class:`ModelShards` of the group's positions, any other its
    lead position's tensor or serving leaf."""
    from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten

    out = []
    for path, leaf in tree_leaves_with_path(placed):
        row = leaf.mesh.groups()[g]
        if any(a in BATCH_AXES for e in leaf.spec for a in entry_axes(e)):
            raise NotImplementedError(f"{path}: a leaf split over a batch axis "
                                      f"({leaf.spec}) has no serving route")
        dim = leaf.model_dim()
        out.append(leaf.local.flat[row[0]] if dim is None
                   else ModelShards([leaf.local.flat[p] for p in row], dim))
    return tree_unflatten(placed, out)


def _device(part) -> torch.device:
    return part.device if isinstance(part, torch.Tensor) else part.packed.device


def all_gather(parts: list, dim: int, device) -> torch.Tensor:
    """The model positions' outputs concatenated on ``dim`` in position
    order, on ``device`` (the group's lead position)."""
    all_gather.count += 1
    return torch.cat([p.to(device) for p in parts], dim=dim)


all_gather.count = 0


def all_reduce(parts: list, device) -> torch.Tensor:
    """The model positions' partial results summed in position order, on
    ``device``."""
    all_reduce.count += 1
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


all_reduce.count = 0


def collective_counts() -> dict[str, int]:
    return {"all-gather": all_gather.count, "all-reduce": all_reduce.count}


def reset_collective_counts() -> None:
    all_gather.count = all_reduce.count = 0


def sharded_linear(w: ModelShards, x: torch.Tensor) -> torch.Tensor:
    """x @ w for a leaf split over "model": column parallel (``dim`` -1:
    each position's product on its N shard, then an all-gather) or row
    parallel (``dim`` -2: each position's exact partial on its contraction
    range, ``engine.backends.row_partial``, then an all-reduce and
    ``row_finish``, the scale applied once)."""
    from repro_torch.engine import backends, registry

    if not isinstance(x, torch.Tensor):
        raise NotImplementedError("sign words from a fused producer have no mesh route")
    if w.dim == -1:
        return all_gather([registry.apply_linear(p, x.to(_device(p))) for p in w.parts],
                          -1, x.device)
    if w.dim != -2:
        raise NotImplementedError(f"a linear leaf split on master dim {w.dim}")
    partials, start = [], 0
    for p in w.parts:
        k = p.k if hasattr(p, "k") else p.shape[-2]
        partials.append(backends.row_partial(p, x[..., start:start + k].to(_device(p))))
        start += k
    if start != x.shape[-1]:
        raise ValueError(f"row shards cover K={start}, the activation has {x.shape[-1]}")
    return backends.row_finish(w.parts[0], all_reduce(partials, x.device), x.dtype)


def sharded_embed_lookup(w: ModelShards, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Vocab-parallel lookup of a (V, D) table split on V: each position
    takes its rows (``F.embedding`` on the shard, zeros for tokens outside
    it), and the all-reduce's sum is exact (one shard's row plus zeros)."""
    if w.dim != -2:
        raise NotImplementedError(f"an embedding split on master dim {w.dim}")
    rows, start = [], 0
    for p in w.parts:
        v = p.shape[0]
        local = tokens.to(p.device) - start
        hit = (local >= 0) & (local < v)
        got = F.embedding(torch.where(hit, local, torch.zeros_like(local)), p)
        rows.append(torch.where(hit[..., None], got, torch.zeros((), dtype=got.dtype,
                                                                 device=got.device)))
        start += v
    return all_reduce(rows, tokens.device).to(dtype)


def sharded_head(w: ModelShards, x: torch.Tensor, *, tied: bool) -> torch.Tensor:
    """Vocab-parallel head: each position casts only its shard to x's dtype
    (every call, as the unsharded head casts the whole master) and takes
    its product; the logits are gathered on V after it. ``tied``: ``w`` is
    the (V, D) embedding split on V, used transposed."""
    if w.dim != (-2 if tied else -1):
        raise NotImplementedError(f"a head split on master dim {w.dim}")
    outs = []
    for p in w.parts:
        wp = p.to(x.dtype)
        outs.append(torch.matmul(x.to(p.device), wp.T if tied else wp))
    return all_gather(outs, -1, x.device)
