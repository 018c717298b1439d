"""Deterministic synthetic data (the machines are offline).

* ``mnist_like`` -- 784-dim images in [0, 1], 10 classes: class prototypes
  plus Gaussian noise.
* ``cifar_like`` -- (32, 32, 3) NHWC images in [0, 1], 10 classes: 8x8x3
  prototypes upsampled bilinearly, plus low-frequency noise.
* ``lm_tokens`` -- token streams with a Zipf marginal and a bigram drift.

The image generators have the same distribution as the reference's (not
the same numbers): batch ``step`` is a pure function of (seed, step), drawn
from seeded ``torch.Generator``s on the target device. ``lm_tokens`` is the
reference's twin, token for token, through the threefry twin
(``core.prng``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import prng

N_CLASSES = 10
_SEED_STRIDE = 1_000_003


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    kind: str                 # "mnist" | "cifar" | "lm"
    batch_size: int
    seed: int = 0
    n_train: int = 0          # the training set's size, for steps_per_epoch
    seq_len: int = 0          # "lm": tokens a row, before the extra label
    vocab_size: int = 0       # "lm"

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


def lm_tokens(spec: SyntheticSpec, step: int, *, device) -> torch.Tensor:
    """-> tokens (B, S+1) int32, the reference's (``data.synthetic.lm_tokens``)
    token for token; inputs are ``[:, :-1]``, labels ``[:, 1:]``.

    A Zipf marginal, ranks ``floor(u^(-1/1.1)) % V`` of uniforms over
    [1e-6, 1), with a deterministic bigram drift: where a Bernoulli(0.3)
    draw says so, the token is ``(previous rank * 7 + 13) % V`` (the
    previous of the first being the row's last). Computed on the CPU and
    moved to ``device``: f32 ``pow`` differs between libraries in its last
    ulp, and torch's CPU one gives the reference's floors where a card's
    ``powf`` need not."""
    k1, k2 = prng.split(prng.fold_in(prng.key(spec.seed + 2), step))
    shape = (spec.batch_size, spec.seq_len + 1)
    v = spec.vocab_size
    u = prng.uniform(k1, shape, minval=1e-6)
    base = (torch.floor(torch.pow(u, -1.0 / 1.1)) % v).to(torch.int32)
    shifted = torch.roll(base, 1, dims=1)
    mix = prng.uniform(k2, shape) < torch.tensor(0.3, dtype=torch.float32)
    return torch.where(mix, (shifted * 7 + 13) % v, base).to(device)


def train_batch(spec: SyntheticSpec, step: int, *, device):
    if spec.kind == "mnist":
        return mnist_like(spec, step, device=device)
    if spec.kind == "cifar":
        return cifar_like(spec, step, device=device)
    if spec.kind == "lm":
        return lm_tokens(spec, step, device=device)
    raise ValueError(f"unknown synthetic data kind {spec.kind!r}")


def eval_batch(spec: SyntheticSpec, step: int = 10_000_000, *, device):
    """A held-out batch (a step index far outside the training range)."""
    return train_batch(spec, step, device=device)
