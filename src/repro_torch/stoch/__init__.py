"""Stochastic ensemble: K-replica packed BNN inference.

The paper's stochastically binarized network (Eq. 2-3) is a distribution
over binary networks. ``sample_replicas`` draws K complete packed replicas
of it, ``ensemble_forward`` runs the model over each of them through the
normal kernel path, and ``ensemble_stats`` condenses the replica logits
into mean logits, logit variance and vote agreement. Leaves the plan does
not binarize are stored once and shared by every replica.

Placing replicas on a mesh (the reference's ``replica_specs`` and
``place_replicas``) waits for a mesh on the card (ROADMAP, queue 7).
"""
from repro_torch.stoch.ensemble import EnsembleStats, ensemble_forward, ensemble_stats
from repro_torch.stoch.replicas import ReplicaSet, replica_key, sample_replicas

__all__ = ["EnsembleStats", "ReplicaSet", "ensemble_forward", "ensemble_stats",
           "replica_key", "sample_replicas"]
