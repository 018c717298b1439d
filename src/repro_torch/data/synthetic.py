"""Deterministic synthetic image data (the machines are offline).

* ``mnist_like`` -- 784-dim images in [0, 1], 10 classes: class prototypes
  plus Gaussian noise.
* ``cifar_like`` -- (32, 32, 3) NHWC images in [0, 1], 10 classes: 8x8x3
  prototypes upsampled bilinearly, plus low-frequency noise.

Each has the same distribution as the reference's generator (not the same
numbers). Batch ``step`` is a pure function of (seed, step), drawn from
seeded ``torch.Generator``s on the target device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

N_CLASSES = 10
_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    kind: str                 # "mnist" | "cifar"
    batch_size: int
    seed: int = 0
    n_train: int = 0          # the training set's size, for steps_per_epoch

    @property
    def steps_per_epoch(self) -> int:
        return max(self.n_train // self.batch_size, 1)


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


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8, 3) -> (B, 32, 32, 3), bilinear (half-pixel centres)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(32, 32), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def cifar_like(spec: SyntheticSpec, step: int, *, device):
    """-> (images (B, 32, 32, 3) f32 in [0, 1], labels (B,) int64)."""
    g_proto = _generator((spec.seed + 1) ^ 0x5EED, device)
    proto = _upsample(torch.rand((N_CLASSES, 8, 8, 3), generator=g_proto, device=device))
    g = _generator((spec.seed + 1) * _SEED_STRIDE + step + 1, device)
    labels = torch.randint(0, N_CLASSES, (spec.batch_size,), generator=g, device=device)
    lowf = torch.randn((spec.batch_size, 8, 8, 3), generator=g, device=device)
    x = torch.clamp(proto[labels] + 0.25 * _upsample(lowf), 0.0, 1.0)
    return x.contiguous(), labels


def train_batch(spec: SyntheticSpec, step: int, *, device):
    if spec.kind == "mnist":
        return mnist_like(spec, step, device=device)
    if spec.kind == "cifar":
        return cifar_like(spec, step, device=device)
    raise ValueError(f"only the mnist and cifar generators are ported, not {spec.kind!r}")


def eval_batch(spec: SyntheticSpec, step: int = 10_000_000, *, device):
    """A held-out batch (a step index far outside the training range)."""
    return train_batch(spec, step, device=device)
