"""Deterministic synthetic MNIST-shaped data (the machines are offline).

``mnist_like`` draws 784-dim images in [0, 1] with 10 classes: class
prototypes plus Gaussian noise, the same distribution as the reference's
generator (not the same numbers). Batch ``step`` is a pure function of
(seed, step), drawn from seeded ``torch.Generator``s on the target device.
"""
from __future__ import annotations

import dataclasses

import torch

N_CLASSES = 10
_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    kind: str                 # "mnist"
    batch_size: int
    seed: int = 0


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def mnist_like(spec: SyntheticSpec, step: int, *, device):
    """-> (images (B, 784) f32 in [0, 1], labels (B,) int64)."""
    proto = torch.rand((N_CLASSES, 784), generator=_generator(spec.seed ^ 0x5EED, device),
                       device=device)
    g = _generator(spec.seed * _SEED_STRIDE + step + 1, device)
    labels = torch.randint(0, N_CLASSES, (spec.batch_size,), generator=g, device=device)
    noise = 0.35 * torch.randn((spec.batch_size, 784), generator=g, device=device)
    return torch.clamp(proto[labels] + noise, 0.0, 1.0), labels


def train_batch(spec: SyntheticSpec, step: int, *, device):
    if spec.kind != "mnist":
        raise ValueError(f"only the mnist generator is ported, not {spec.kind!r}")
    return mnist_like(spec, step, device=device)
