"""Carries parameter trees from the reference package into the port.

``from_jax_tree`` takes a tree of dicts and lists whose leaves are arrays
(numpy, or anything with ``__array__``), numbers, or the reference's serving
leaves, and returns the same tree with torch tensors and the port's serving
leaves. A serving leaf is recognised by its class name (``PackedLinear``,
``XnorLinear``, ``XnorConv``, ``PackedConv``), never by its attributes:
all four have ``packed`` and ``k``, but their word layouts differ. Any
other class raises. Array bits are kept as they are: int32 packed words
keep their bit patterns. ``from_jax_train_state`` carries a whole train
state across (``train.steps``'s tree: params, optimizer slots, step, key,
model state, compression residuals).
"""
from __future__ import annotations

import numbers
from typing import Any

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.layers import PackedConv, PackedLinear, XnorConv, XnorLinear

_LINEAR = {"PackedLinear": PackedLinear, "XnorLinear": XnorLinear}
_CONV = {"XnorConv": XnorConv, "PackedConv": PackedConv}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_tree(tree: Any, *, device="cuda") -> Any:
    """Reference tree (master params and state, or a packed tree) -> port tree."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_tree(v, device=device) for v in tree]
    name = type(tree).__name__
    if name in _LINEAR or name in _CONV:
        packed = _tensor(tree.packed, device)
        scale = None if tree.scale is None else _tensor(tree.scale, device)
        if name in _LINEAR:
            return _LINEAR[name](packed, scale, int(tree.k))
        return _CONV[name](packed, scale, tuple(int(s) for s in tree.ksize), int(tree.c_in))
    if isinstance(tree, numbers.Number) or hasattr(tree, "__array__"):
        return _tensor(tree, device)
    raise TypeError(f"from_jax_tree: unknown leaf class {type(tree).__qualname__!r}")


def from_jax_train_state(state: dict, *, device="cuda") -> dict:
    """A reference train state (``repro.train.steps.init_train_state``'s
    tree) with numpy leaves, ``key`` given as its ``jax.random.key_data``
    (uint32, shape (2,)) -> the port's: ``key`` a ``core.prng.Key``,
    ``step`` an int32 0-d tensor on the CPU, every other leaf a tensor on
    ``device``."""
    out = {}
    for name, sub in state.items():
        if name == "key":
            k0, k1 = np.asarray(sub).astype(np.uint32).tolist()
            out[name] = prng.Key(int(k0), int(k1))
        elif name == "step":
            out[name] = torch.tensor(int(np.asarray(sub)), dtype=torch.int32)
        else:
            out[name] = from_jax_tree(sub, device=device)
    return out
