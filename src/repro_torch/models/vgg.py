"""VGG-16 for CIFAR-10 (the paper's CNN benchmark, section III-A).

13 convs in 5 blocks with a 2x2 max-pool after each block, batch norm after
every layer and a compact head (512 -> 512 -> 10), on 32x32x3 NHWC inputs.
The parameter tree has the reference's keys (``conv/<i>/kernel``,
``fc/<i>/kernel``, ...), so plan paths match its manifests. Convolutions go
through ``apply_conv2d`` (NHWC/HWIO), so a conv leaf may be a dense or
binarized-dense kernel, a :class:`PackedConv` or an :class:`XnorConv`. In
training mode (Alg. 1, ``train.steps``) batch norm uses the batch's
statistics (over N, H, W at the convs) and ``apply`` returns the moved
running stats too.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.binarize import binarize
from repro_torch.models.layers import (apply_conv2d, apply_linear, bn_sign, bn_sign_words,
                                       he_normal, layer_batch_norm, max_pool2x2,
                                       takes_sign_words)

# VGG-16: numbers are output channels, "M" is a max-pool.
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
N_CLASSES = 10


def _layer(generator, shape, fan_in, c_out, device):
    params = {
        "kernel": he_normal(generator, shape, device=device, fan_in=fan_in),
        "bias": torch.zeros(c_out, device=device),
        "bn_scale": torch.ones(c_out, device=device),
        "bn_bias": torch.zeros(c_out, device=device),
    }
    state = {"mean": torch.zeros(c_out, device=device),
             "var": torch.ones(c_out, device=device)}
    return params, state


def init(generator: torch.Generator, width_mult: float = 1.0, in_channels: int = 3,
         n_classes: int = N_CLASSES, fc_dim: int = 512, *, device) -> dict:
    """Master weights and batch-norm running stats, drawn from ``generator``
    (which must live on ``device``)."""
    params: dict[str, Any] = {"conv": [], "fc": []}
    state: dict[str, Any] = {"conv": [], "fc": []}
    c_in = in_channels
    for v in VGG16_CFG:
        if v == "M":
            continue
        c_out = max(8, int(v * width_mult))
        p, s = _layer(generator, (3, 3, c_in, c_out), 9 * c_in, c_out, device)
        params["conv"].append(p)
        state["conv"].append(s)
        c_in = c_out
    fc_d = max(8, int(fc_dim * width_mult))
    dims = (c_in, fc_d, fc_d, n_classes)     # 1x1 spatial after 5 pools on 32x32
    for a, b in zip(dims[:-1], dims[1:]):
        p, s = _layer(generator, (a, b), a, b, device)
        params["fc"].append(p)
        state["fc"].append(s)
    return {"params": params, "state": state}


def apply(params: dict, state: dict, x: torch.Tensor, *, training: bool = False,
          binary_act: bool = False):
    """x: (B, 32, 32, 3) NHWC -> logits (B, 10) in eval mode, or
    ``(logits, new_state)`` with ``training=True`` (batch statistics; the
    reference's return).

    With ``binary_act`` the non-linearity is the Eq.-1 sign instead of ReLU
    on exactly the activations that feed binary-activation layers: conv
    outputs 1..11 (the inputs of the XnorConv blocks 2-5) and the head's
    hidden layers. conv/0 -> conv/1 and conv/12 -> fc/0 keep ReLU, matching
    ``core.policy.XNOR_POLICY``. In eval mode the bias, batch norm and sign
    of a sign site run in one kernel: inside the next head layer's K3 where
    that layer reads sign words (``bn_sign_words``), else ``bn_sign`` (the
    conv is then applied without its bias, which ``bn_sign`` adds). In
    training mode the sign is the straight-through ``binarize(., "det")``."""
    new_state: dict[str, Any] = {"conv": [], "fc": []}
    ci, n_conv = 0, len(params["conv"])
    for v in VGG16_CFG:
        if v == "M":
            x = max_pool2x2(x)
            continue
        lp, ls = params["conv"][ci], state["conv"][ci]
        sign_act = binary_act and 1 <= ci < n_conv - 1
        ci += 1
        if sign_act and not training:
            x = bn_sign(apply_conv2d(lp["kernel"], x, stride=(1, 1), padding="SAME"),
                        lp["bias"], lp["bn_scale"], lp["bn_bias"], ls["mean"], ls["var"])
            continue
        x = apply_conv2d(lp["kernel"], x, lp["bias"], stride=(1, 1), padding="SAME")
        x = layer_batch_norm(x, lp, ls, training=training, new_state=new_state["conv"],
                             axes=(0, 1, 2))
        x = binarize(x, "det") if sign_act else torch.relu(x)
    x = x.reshape(x.shape[0], -1)
    n = len(params["fc"])
    for i, (lp, ls) in enumerate(zip(params["fc"], state["fc"])):
        hidden = i < n - 1
        if binary_act and hidden and not training:
            vecs = (lp["bias"], lp["bn_scale"], lp["bn_bias"], ls["mean"], ls["var"])
            x = apply_linear(lp["kernel"], x)
            fused = takes_sign_words(params["fc"][i + 1]["kernel"])
            x = bn_sign_words(x, *vecs) if fused else bn_sign(x, *vecs)
            continue
        x = apply_linear(lp["kernel"], x, lp["bias"])
        x = layer_batch_norm(x, lp, ls, training=training, new_state=new_state["fc"])
        if hidden:
            x = binarize(x, "det") if binary_act else torch.relu(x)
    return (x, new_state) if training else x
