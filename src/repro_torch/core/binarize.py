"""Binary weight regularization, Eq. (1)-(3) of the paper, in torch.

* Eq. (1)  deterministic binarization  w_b = +1 if w > 0 else -1,
  where "w > 0" reads ``w >= SIGN_MIN`` (see below),
* Eq. (2)  stochastic binarization     P(w_b = +1) = sigma(w),
* Eq. (3)  hard sigmoid                sigma(x) = clip((x + 1) / 2, 0, 1),
* Alg. (1) the training algorithm's ``binarize()``: real-valued master
  weights are binarized on every forward/backward pass, gradients reach
  them through a straight-through estimator (STE), and the masters are
  clipped to [-1, 1] after each update (``binarize_tree``, ``clip_tree``).

Every random draw takes an explicit key (``core.prng``), and draws the
reference's numbers at the same key, so a stochastic training step draws
the reference's +-1 weights bit for bit.
"""
from __future__ import annotations

import enum
from typing import Any

import torch

from repro_torch.core import prng

#: The least f32/bf16 value Eq. 1 signs +1: the smallest normal f32, 2^-126
#: (FLT_MIN; bf16 has f32's exponent range). Subnormals of either sign, +-0
#: and NaN sign -1, as in the reference, whose XLA CPU reads a subnormal as
#: zero (the TPU has none). The kernels hold the same value
#: (``kernels/csrc/common.cuh``: kBnnSignMin).
SIGN_MIN = 2.0 ** -126


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every value of magnitude below ``SIGN_MIN`` (the
    subnormals and +-0) set to a zero of its sign; NaN and everything else
    pass. This is what the reference's XLA CPU does to every input and
    every result of an f32 operation (DAZ and FTZ set): a chain that flushes
    where it does gives its bits (``xnor.kernel.bn_sign_plain``)."""
    return torch.where(t.abs() < SIGN_MIN, torch.copysign(torch.zeros_like(t), t), t)


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


class _StraightThrough(torch.autograd.Function):
    """Forward: the binarized weight itself. Backward: the cotangent goes to
    the master weight unchanged (Alg. 1's STE; the saturation outside
    [-1, 1] comes from ``clip_tree`` on the masters, as the paper's step 4)."""

    @staticmethod
    def forward(ctx, w, key):
        wd = w.detach()
        return deterministic_binarize(wd) if key is None else stochastic_binarize(wd, key)

    @staticmethod
    def backward(ctx, g):
        return g, None


def binarize(w: torch.Tensor, mode: BinarizeMode | str,
             key: prng.Key | None = None) -> torch.Tensor:
    """Alg. (1) ``binarize()``: a tensor of w's shape and dtype whose values
    are the binarized weight (Eq. 1, or Eq. 2 at ``key``; ``w`` itself for
    NONE) and whose gradient goes to ``w`` unchanged."""
    mode = BinarizeMode.parse(mode)
    if mode is BinarizeMode.NONE:
        return w
    if mode is BinarizeMode.STOCHASTIC and key is None:
        raise ValueError("stochastic binarization requires a PRNG key")
    return _StraightThrough.apply(w, key if mode is BinarizeMode.STOCHASTIC else None)


def binarize_tree(params: Any, mode: BinarizeMode | str, policy,
                  key: prng.Key | None = None) -> Any:
    """``binarize`` on every leaf whose path (``layers/1/kernel``) ``policy``
    selects; the other leaves pass through. In the stochastic mode the key
    is split once over the selected leaves, in tree order, as the
    reference splits it."""
    from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten

    mode = BinarizeMode.parse(mode)
    if mode is BinarizeMode.NONE:
        return params
    leaves = list(tree_leaves_with_path(params))
    selected = [policy.selects(path) for path, _ in leaves]
    keys: list = [None] * len(leaves)
    if mode is BinarizeMode.STOCHASTIC:
        if key is None:
            raise ValueError("stochastic binarization requires a PRNG key")
        it = iter(prng.split(key, max(sum(selected), 1)))
        keys = [next(it) if sel else None for sel in selected]
    return tree_unflatten(params, (binarize(leaf, mode, k) if sel else leaf
                                   for (_, leaf), sel, k in zip(leaves, selected, keys)))


def clip_tree(params: Any, policy) -> Any:
    """Alg. (1) step 4 over a tree: the selected master weights clipped to
    [-1, 1]."""
    from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten

    return tree_unflatten(params, (clip_weights(leaf) if policy.selects(path) else leaf
                                   for path, leaf in tree_leaves_with_path(params)))
