"""Feed-forward blocks: SwiGLU (llama family) and the 2-matmul GELU
(starcoder2), as the reference's ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_linear


def init_mlp(generator: torch.Generator, cfg, init_fn, *, device, n_layers: int,
             d_ff: int | None = None) -> dict:
    """``n_layers`` stacked feed-forward blocks."""
    d_ff = d_ff or cfg.d_ff
    d, n = cfg.d_model, n_layers
    if cfg.mlp_type == "glu":
        return {"w_gate": init_fn(generator, (n, d, d_ff), device=device),
                "w_up": init_fn(generator, (n, d, d_ff), device=device),
                "w_down": init_fn(generator, (n, d_ff, d), device=device)}
    return {"wi": init_fn(generator, (n, d, d_ff), device=device),
            "wo": init_fn(generator, (n, d_ff, d), device=device)}


def mlp(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        g = apply_linear(params["w_gate"], x)
        u = apply_linear(params["w_up"], x)
        return apply_linear(params["w_down"], F.silu(g) * u)
    h = apply_linear(params["wi"], x)
    # jax.nn.gelu's default is the tanh approximation
    return apply_linear(params["wo"], F.gelu(h, approximate="tanh"))
