"""Loss functions: softmax cross-entropy (the paper's choice) and accuracy
for the classifiers."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy. logits (..., C) of any float dtype; labels (...) int."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).to(torch.float32).mean()
