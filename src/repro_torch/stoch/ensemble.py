"""Ensemble forward and its uncertainty statistics.

``ensemble_forward`` runs a model function once per replica of a
:class:`~repro_torch.stoch.replicas.ReplicaSet`, each through the normal
kernel path (the reference vmaps over the replica dim; the kernels here do
not vmap, so this loops, and K2 launches once per replica and packed
layer). ``ensemble_stats`` condenses the (K, ..., V) replica logits into
mean logits, mean per-logit variance across replicas, and vote agreement
(the share of replicas whose argmax is the argmax of the mean).

``place_replicas`` puts a ReplicaSet on a mesh: base leaves follow the
plan's sharding column as single-sample serving does, and each stacked
leaf gets the plan's ``replica_axis`` ("data", "model" or None) prepended
to its row's column (:func:`replica_specs`), so the replicas split over
that axis while every inner dim keeps its single-replica placement.
:func:`replica_view` gives the tree one replica runs in one data group, and
the position that runs it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.stoch.replicas import ReplicaSet, _index_node, _substitute, _tensor_fields


@dataclasses.dataclass
class EnsembleStats:
    """Per-input ensemble summary, all f32.

    ``mean_logits``  (..., V)  ensemble-mean logits (what is decoded)
    ``variance``     (...,)    across-replica logit variance, meaned over V
    ``agreement``    (...,)    share of replicas voting with the ensemble
    """

    mean_logits: torch.Tensor
    variance: torch.Tensor
    agreement: torch.Tensor


def ensemble_stats(rep_logits: torch.Tensor) -> EnsembleStats:
    """(K, ..., V) replica logits -> :class:`EnsembleStats`. A unanimous
    ensemble has agreement 1.0 whatever K."""
    x = rep_logits.to(torch.float32)
    mean = x.mean(dim=0)
    variance = x.var(dim=0, correction=0).mean(dim=-1)
    votes = x.argmax(dim=-1)
    winner = mean.argmax(dim=-1)
    agreement = (votes == winner[None]).to(torch.float32).mean(dim=0)
    return EnsembleStats(mean, variance, agreement)


def ensemble_forward(rs: ReplicaSet, fn: Callable[[Any], torch.Tensor], *,
                     stats: bool = True):
    """``fn(serving_tree) -> logits`` once per replica. Returns
    :class:`EnsembleStats`, or with ``stats=False`` the (K, ..., V) replica
    logits. K = 1 calls ``fn(rs.base)`` alone, so it is the single-sample
    forward bit for bit."""
    if rs.k == 1:
        logits = fn(rs.base)[None]
    else:
        logits = torch.stack([fn(rs.merge_replica(r)) for r in range(rs.k)])
    return ensemble_stats(logits) if stats else logits


def prepend_replica_axis(rax: Optional[str], spec) -> tuple:
    """``(rax, *spec)`` with ``rax`` taken out of the inner entries first (a
    mesh-axis name may appear once in a spec, and the replica axis wins the
    clash; a tuple entry left with one name becomes that name, as a
    ``PartitionSpec`` holds it). ``rax=None`` prepends a replicated leading
    dim."""
    entries = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a != rax)
            entries.append(kept[0] if len(kept) == 1 else kept or None)
        else:
            entries.append(None if e == rax else e)
    return (rax, *entries)


def replica_specs(rs: ReplicaSet, *, mesh=None) -> dict[str, Any]:
    """The spec of every stored array of the *stacked* nodes of ``rs``: the
    plan's ``replica_axis`` on the leading (K,) dim and the row's sharding
    column, adapted to the array's rank, on the inner dims
    (:func:`prepend_replica_axis`). Path -> a spec for a tensor node, or
    {field: spec} for a serving node, in its fields' order. With ``mesh``
    each spec is sanitized against the array's shape: a K that does not
    divide the axis replicates the stack."""
    rax = rs.plan.replica_axis
    out: dict[str, Any] = {}
    for path, node in rs.stacked.items():
        spec = rs.plan[path].pspec
        if spec is None:                      # a v1 manifest's row: re-derive
            spec = SH.serving_leaf_pspec(path, _index_node(node, 0))

        def spec_for(a: torch.Tensor, spec=spec):
            full = prepend_replica_axis(rax, SH._adapt_spec(spec, a.ndim - 1))
            return SH.sanitize_spec(mesh, full, a.shape) if mesh is not None else full

        out[path] = (spec_for(node) if isinstance(node, torch.Tensor)
                     else {f: spec_for(getattr(node, f)) for f in _tensor_fields(node)})
    return out


def place_replicas(mesh, rs: ReplicaSet, plan=None) -> ReplicaSet:
    """``rs`` placed on ``mesh``: base leaves by ``plan``'s sharding column
    (default ``rs.plan``; ``distributed.sharding.place_packed_params``), each
    stacked node's arrays by :func:`replica_specs`, so its lead (K) dim
    carries ``rs.plan.replica_axis``. A ``replica_axis`` of None, or a K
    the axis does not divide, replicates the stack. The nodes of the result
    are ``distributed.sharding.Placed`` leaves."""
    plan = plan if plan is not None else rs.plan
    base = SH.place_packed_params(mesh, rs.base, plan)
    specs = replica_specs(rs, mesh=mesh)
    stacked = {path: SH._place_node(mesh, None, node, specs[path])
               for path, node in rs.stacked.items()}
    return ReplicaSet(base=base, stacked=stacked, k=rs.k, paths=rs.paths, plan=rs.plan)


def replica_view(placed: ReplicaSet, r: int, g: int) -> Optional[tuple[int, Any]]:
    """(position, tree) of replica ``r`` in data group ``g`` of a ReplicaSet
    placed by :func:`place_replicas`, or None where the group holds no copy
    of it (the replicas split over a batch axis). The position is the flat
    index of the group's position that runs the replica's call: the one
    holding the replica's stacked leaves whole where they split over
    "model", else the group's lead position. A stacked leaf whose inner dims
    split over "model" is the group's :class:`~repro_torch.distributed.
    sharding.ModelShards` of the replica, any other the holder's slice."""
    mesh = next(iter(placed.stacked.values())).mesh
    sizes = mesh.axis_sizes()
    row = [int(p) for p in mesh.groups()[g]]
    pos, nodes = None, {}
    for path, leaf in placed.stacked.items():
        lead = leaf.spec[0] if leaf.spec else None
        per = placed.k // math.prod(sizes[a] for a in SH.entry_axes(lead))
        hold = [p for p in row if SH._shard_index(mesh, lead, p) == r // per]
        if not hold:
            return None
        dims = [d - len(leaf.spec) for d, e in enumerate(leaf.spec)
                if d and SH.MODEL in SH.entry_axes(e)]
        if dims:
            nodes[path] = SH.ModelShards([leaf.local.flat[p][r % per] for p in row], dims[0])
        else:
            nodes[path] = leaf.local.flat[hold[0]][r % per]
            if SH.MODEL in SH.entry_axes(lead):
                pos = hold[0]
    pos = row[0] if pos is None else pos
    return pos, _substitute(SH.group_view(placed.base, g, lead=pos), nodes)
