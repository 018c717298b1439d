"""Carries parameter trees from the reference package into the port.

``from_jax_tree`` takes a tree of dicts and lists whose leaves are arrays
(numpy, or anything ``numpy.asarray`` accepts) or packed serving leaves
(any object with ``packed``, ``scale`` and ``k`` attributes), and returns
the same tree with torch tensors and :class:`PackedLinear` leaves. Array
bits are kept as they are: int32 packed words keep their bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.layers import PackedLinear


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_tree(tree: Any, *, device="cuda") -> Any:
    """Reference tree (master params and state, or a packed tree) -> port tree."""
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_tree(v, device=device) for v in tree]
    if hasattr(tree, "packed") and hasattr(tree, "k"):
        scale = None if tree.scale is None else _tensor(tree.scale, device)
        return PackedLinear(_tensor(tree.packed, device), scale, int(tree.k))
    return _tensor(tree, device)
