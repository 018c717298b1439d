"""Binary weight regularization, Eq. (1)-(3) of the paper, in torch.

* Eq. (1)  deterministic binarization  w_b = +1 if w > 0 else -1,
  where "w > 0" reads ``w >= SIGN_MIN`` (see below),
* Eq. (2)  stochastic binarization     P(w_b = +1) = sigma(w),
* Eq. (3)  hard sigmoid                sigma(x) = clip((x + 1) / 2, 0, 1).

Every random draw takes an explicit key (``core.prng``), and draws the
reference's numbers at the same key. The straight-through estimator and the tree-level binarization arrive with the
training slice.
"""
from __future__ import annotations

import enum

import torch

from repro_torch.core import prng

#: The least f32/bf16 value Eq. 1 signs +1: the smallest normal f32, 2^-126
#: (FLT_MIN; bf16 has f32's exponent range). Subnormals of either sign, +-0
#: and NaN sign -1, as in the reference, whose XLA CPU reads a subnormal as
#: zero (the TPU has none). The kernels hold the same value
#: (``kernels/csrc/common.cuh``: kBnnSignMin).
SIGN_MIN = 2.0 ** -126


def sign_bit(x: torch.Tensor) -> torch.Tensor:
    """Eq. 1 as a bool tensor: True iff ``x >= SIGN_MIN`` (f32 or bf16)."""
    return x >= SIGN_MIN


class BinarizeMode(enum.Enum):
    """Which regularizer Alg. 1's ``binarize()`` uses."""

    NONE = "none"
    DETERMINISTIC = "det"
    STOCHASTIC = "stoch"

    @classmethod
    def parse(cls, value: "BinarizeMode | str | None") -> "BinarizeMode":
        if value is None:
            return cls.NONE
        if isinstance(value, cls):
            return value
        for m in cls:
            if value in (m.value, m.name, m.name.lower()):
                return m
        raise ValueError(f"unknown binarize mode: {value!r}")


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Eq. (3): sigma(x) = clip((x + 1) / 2, 0, 1)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def clip_weights(w: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """Alg. (1) step 4: keeps master weights inside [-1, 1]."""
    return torch.clamp(w, lo, hi)


def deterministic_binarize(w: torch.Tensor) -> torch.Tensor:
    """Eq. (1): +1 where ``w >= SIGN_MIN``, -1 elsewhere (subnormals, +-0,
    NaN and the negatives), in w's dtype."""
    return torch.where(sign_bit(w), 1.0, -1.0).to(w.dtype)


def stochastic_binarize(w: torch.Tensor, key: prng.Key) -> torch.Tensor:
    """Eq. (2): +1 with probability hard_sigmoid(w), else -1."""
    p = hard_sigmoid(w.to(torch.float32))
    u = prng.uniform(key, w.shape, w.device)
    return torch.where(u < p, 1.0, -1.0).to(w.dtype)
