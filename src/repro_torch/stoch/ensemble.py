"""Ensemble forward and its uncertainty statistics.

``ensemble_forward`` runs a model function once per replica of a
:class:`~repro_torch.stoch.replicas.ReplicaSet`, each through the normal
kernel path (the reference vmaps over the replica dim; the kernels here do
not vmap, so this loops, and K2 launches once per replica and packed
layer). ``ensemble_stats`` condenses the (K, ..., V) replica logits into
mean logits, mean per-logit variance across replicas, and vote agreement
(the share of replicas whose argmax is the argmax of the mean).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.stoch.replicas import ReplicaSet


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
