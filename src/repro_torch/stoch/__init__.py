"""Stochastic ensemble: K-replica packed BNN inference.

The paper's stochastically binarized network (Eq. 2-3) is a distribution
over binary networks. ``sample_replicas`` draws K complete packed replicas
of it, ``ensemble_forward`` runs the model over each of them through the
normal kernel path, and ``ensemble_stats`` condenses the replica logits
into mean logits, logit variance and vote agreement. Leaves the plan does
not binarize are stored once and shared by every replica.

``place_replicas`` puts the replicas on a mesh: the stacked leaves' lead (K)
dim over the plan's ``replica_axis`` (``replica_specs``,
``prepend_replica_axis``), the shared leaves by the plan's sharding column;
``ServeEngine(cfg, None, ensemble=rs, mesh=mesh, plan=plan)`` serves them.
"""
from repro_torch.stoch.ensemble import (EnsembleStats, ensemble_forward, ensemble_stats,
                                        place_replicas, prepend_replica_axis, replica_specs,
                                        replica_view)
from repro_torch.stoch.replicas import ReplicaSet, replica_key, sample_replicas

__all__ = ["EnsembleStats", "ReplicaSet", "ensemble_forward", "ensemble_stats",
           "place_replicas", "prepend_replica_axis", "replica_key", "replica_specs",
           "replica_view", "sample_replicas"]
