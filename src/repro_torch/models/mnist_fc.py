"""The paper's permutation-invariant fully-connected MNIST network.

784 -> hidden -> hidden -> hidden -> 10, batch norm after every layer,
ReLU between layers, He initialization (the paper's section III-A). The
parameter tree has the reference's keys, so plan paths such as
``layers/1/kernel`` match its manifests. ``apply`` is the eval-mode forward
and does not care whether a kernel leaf is a dense tensor or packed; with
``binary_act`` the hidden non-linearity is the Eq.-1 sign (the fully-binary
``xnor`` path).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.binarize import deterministic_binarize
from repro_torch.models.layers import (apply_linear, batch_norm, bn_sign_words, he_normal,
                                       takes_sign_words)

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


def apply(params: dict, state: dict, x: torch.Tensor, *,
          binary_act: bool = False) -> torch.Tensor:
    """x: (B, 784) -> logits (B, 10), eval mode.

    With ``binary_act`` every hidden activation is the Eq.-1 sign (+-1), so
    hidden layers packed as ``XnorLinear`` compute exact XNOR-popcount dot
    products; the first layer still sees the real-valued input. Where the
    next layer reads sign words, the bias, batch norm and sign run inside
    its K3 (``bn_sign_words``)."""
    h = x
    n = len(params["layers"])
    for i, (lp, ls) in enumerate(zip(params["layers"], state["layers"])):
        if binary_act and i < n - 1 and takes_sign_words(params["layers"][i + 1]["kernel"]):
            h = bn_sign_words(apply_linear(lp["kernel"], h), lp["bias"], lp["bn_scale"],
                              lp["bn_bias"], ls["mean"], ls["var"])
            continue
        h = apply_linear(lp["kernel"], h, lp["bias"])
        h = batch_norm(h, lp["bn_scale"], lp["bn_bias"], ls["mean"], ls["var"])
        if i < n - 1:
            h = deterministic_binarize(h) if binary_act else torch.relu(h)
    return h
