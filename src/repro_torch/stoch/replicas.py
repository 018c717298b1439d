"""K-replica sampling of a stochastically binarized network.

One ``plan.pack(params, key)`` freezes one sample of the Eq.-2 weights; this
module draws K of them, K complete packed networks, and holds them with a
leading replica dim, so a forward can average the replicas
(``stoch.ensemble``). Bitpacking keeps this cheap: K = 16 replicas of a
binary layer cost what one bf16 copy of it costs. Leaves the plan does not
binarize (biases, batch-norm parameters, dense layers) are stored once, in
the base tree, and shared by every replica.

Replica r packs with ``replica_key(key, r)``, which is ``key`` itself for
r = 0, so a K = 1 ensemble is bit-identical to ``plan.pack(params, key)``;
within a replica each leaf folds in its index as the engine does. The keys
are the threefry twin's (``core.prng``), so replica r's words equal the
reference's ``sample_replicas`` at ``jax.random.key(seed)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import prng
from repro_torch.core.binarize import BinarizeMode
from repro_torch.engine import registry
from repro_torch.engine.plan import (ExecutionPlan, _leaf_context, tree_leaves_with_path,
                                     tree_unflatten)


def replica_key(key: prng.Key, r: int) -> prng.Key:
    """Key of replica ``r``: ``key`` for r = 0 (so replica 0 is
    ``plan.pack(params, key)`` bit for bit), else ``fold_in(key, r)``."""
    return key if r == 0 else prng.fold_in(key, r)


@dataclasses.dataclass
class ReplicaSet:
    """K packed replicas of one network.

    ``base`` is replica 0's whole serving tree (``plan.pack``'s output; the
    shared leaves live here once). ``stacked`` maps the path of every
    stochastic row to its serving node with each stored tensor stacked on a
    leading (K,) replica dim. ``merge_replica(r)`` gives replica r's whole
    serving tree."""

    base: Any                          # serving tree of replica 0
    stacked: dict[str, Any]            # path -> serving node, tensors (K, ...)
    k: int
    paths: tuple[str, ...]             # stochastic-row paths, tree order
    plan: ExecutionPlan
    _trees: list = dataclasses.field(default_factory=list, repr=False, compare=False)

    def merge_replica(self, r: int) -> Any:
        """The whole serving tree of replica ``r`` (shared leaves and that
        replica's slice of every stacked node)."""
        if not 0 <= r < self.k:
            raise IndexError(f"replica {r} out of range for k={self.k}")
        if not self._trees:
            self._trees.extend(
                _substitute(self.base, {p: _index_node(n, i) for p, n in self.stacked.items()})
                for i in range(self.k))
        return self._trees[r]

    def tree_nbytes(self) -> int:
        """Bytes stored: the shared base leaves plus the K-stacked
        stochastic nodes (replica 0's copy in ``base`` counts once, in the
        stack)."""
        stoch = set(self.paths)
        total = sum(_node_nbytes(n) for p, n in tree_leaves_with_path(self.base)
                    if p not in stoch)
        return total + sum(_node_nbytes(n) for n in self.stacked.values())


def _tensor_fields(node) -> list[str]:
    return [f.name for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)]


def _node_nbytes(node) -> int:
    """Stored bytes of a serving node: a serving leaf's words and scale, or
    a plain tensor's elements."""
    if isinstance(node, torch.Tensor):
        return node.numel() * node.element_size()
    return node.nbytes()


def _index_node(node, r: int):
    """Replica ``r``'s slice of a stacked node."""
    if isinstance(node, torch.Tensor):
        return node[r]
    return dataclasses.replace(node, **{f: getattr(node, f)[r] for f in _tensor_fields(node)})


def _stack_nodes(nodes: list):
    """Stacks the stored tensors of nodes of one class and layout on a new
    leading replica dim; the static fields come from the first."""
    if isinstance(nodes[0], torch.Tensor):
        return torch.stack(nodes)
    return dataclasses.replace(nodes[0], **{
        f: torch.stack([getattr(n, f) for n in nodes]) for f in _tensor_fields(nodes[0])})


def _substitute(base, picked: dict[str, Any]):
    """``base`` with the serving nodes at the given paths replaced."""
    return tree_unflatten(base, (picked.get(p, n) for p, n in tree_leaves_with_path(base)))


def sample_replicas(params, plan: ExecutionPlan, key: prng.Key, k: int) -> ReplicaSet:
    """Draws ``k`` stochastic-binarization samples of ``params`` under
    ``plan``: only ``plan.stochastic_rows()`` are packed anew for each
    replica (K1's threefry mode, once a leaf a replica), everything else is
    packed once and shared. Replica 0 reuses ``plan.pack(params, key)``."""
    if k < 1:
        raise ValueError(f"ensemble size k must be >= 1, got {k}")
    if plan.mode != "stoch":
        raise ValueError(f"sample_replicas needs a stochastic plan (mode='stoch'), got "
                         f"mode={plan.mode!r}: det/xnor packs are keyless, every replica "
                         f"would be identical")
    rows = plan.stochastic_rows()
    masters = dict(tree_leaves_with_path(params))
    base = plan.pack(params, key=replica_key(key, 0))
    base_nodes = dict(tree_leaves_with_path(base))
    stacked: dict[str, Any] = {}
    for a in rows:
        lc = _leaf_context(a, plan.mode)
        spec = registry.get_backend(a.backend)
        reps = [base_nodes[a.path]]
        for r in range(1, k):
            pc = registry.PackContext(weight_mode=BinarizeMode.STOCHASTIC,
                                      key=replica_key(key, r), with_scale=plan.with_scale)
            reps.append(spec.pack(lc, masters[a.path], pc))
        stacked[a.path] = _stack_nodes(reps)
    return ReplicaSet(base=base, stacked=stacked, k=k, paths=tuple(a.path for a in rows),
                      plan=plan)
