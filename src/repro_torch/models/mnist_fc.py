"""The paper's permutation-invariant fully-connected MNIST network.

784 -> hidden -> hidden -> hidden -> 10, batch norm after every layer,
ReLU between layers, He initialization (the paper's section III-A). The
parameter tree has the reference's keys, so plan paths such as
``layers/1/kernel`` match its manifests. ``apply`` does not care whether a
kernel leaf is a dense tensor or packed; with ``binary_act`` the hidden
non-linearity is the Eq.-1 sign (the fully-binary ``xnor`` path). In
training mode (Alg. 1, ``train.steps``) batch norm uses the batch's
statistics and ``apply`` returns the moved running stats too.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.binarize import binarize
from repro_torch.models.layers import (apply_linear, bn_sign, bn_sign_words, he_normal,
                                       layer_batch_norm, takes_sign_words)

DEFAULT_HIDDEN = (2048, 2048, 2048)
N_CLASSES = 10
IN_DIM = 784


def init(generator: torch.Generator, hidden=DEFAULT_HIDDEN, in_dim: int = IN_DIM,
         n_classes: int = N_CLASSES, *, device) -> dict:
    """Master weights and batch-norm running stats, drawn from ``generator``
    (which must live on ``device``)."""
    dims = (in_dim,) + tuple(hidden) + (n_classes,)
    params: dict[str, Any] = {"layers": []}
    state: dict[str, Any] = {"layers": []}
    for a, b in zip(dims[:-1], dims[1:]):
        params["layers"].append({
            "kernel": he_normal(generator, (a, b), device=device),
            "bias": torch.zeros(b, device=device),
            "bn_scale": torch.ones(b, device=device),
            "bn_bias": torch.zeros(b, device=device),
        })
        state["layers"].append({
            "mean": torch.zeros(b, device=device),
            "var": torch.ones(b, device=device),
        })
    return {"params": params, "state": state}


def apply(params: dict, state: dict, x: torch.Tensor, *, training: bool = False,
          binary_act: bool = False):
    """x: (B, 784) -> logits (B, 10) in eval mode, or ``(logits, new_state)``
    with ``training=True`` (batch statistics; the reference's return).

    With ``binary_act`` every hidden activation is the Eq.-1 sign (+-1), so
    hidden layers packed as ``XnorLinear`` compute exact XNOR-popcount dot
    products; the first layer still sees the real-valued input. In eval
    mode the bias, batch norm and sign of a sign site run in one kernel:
    inside the next layer's K3 where that layer reads sign words
    (``bn_sign_words``), else ``bn_sign``. In training mode the sign is the
    straight-through ``binarize(., "det")``."""
    new_state: dict[str, Any] = {"layers": []}
    h = x
    n = len(params["layers"])
    for i, (lp, ls) in enumerate(zip(params["layers"], state["layers"])):
        hidden = i < n - 1
        if binary_act and hidden and not training:
            vecs = (lp["bias"], lp["bn_scale"], lp["bn_bias"], ls["mean"], ls["var"])
            h = apply_linear(lp["kernel"], h)
            fused = takes_sign_words(params["layers"][i + 1]["kernel"])
            h = bn_sign_words(h, *vecs) if fused else bn_sign(h, *vecs)
            continue
        h = apply_linear(lp["kernel"], h, lp["bias"])
        h = layer_batch_norm(h, lp, ls, training=training, new_state=new_state["layers"])
        if hidden:
            h = binarize(h, "det") if binary_act else torch.relu(h)
    return (h, new_state) if training else h
