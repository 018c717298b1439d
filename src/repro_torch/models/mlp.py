"""Feed-forward blocks: SwiGLU (llama family) and the 2-matmul GELU
(starcoder2), as the reference's ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import LeafDraw, apply_linear, draw_leaves


def ffn_projections(cfg, d_ff: int) -> tuple[tuple[str, int, int], ...]:
    """(name, K, N) of a feed-forward block's projections, in draw order:
    ``w_gate``, ``w_up``, ``w_down`` (GLU), or ``wi``, ``wo``."""
    d = cfg.d_model
    if cfg.mlp_type == "glu":
        return (("w_gate", d, d_ff), ("w_up", d, d_ff), ("w_down", d_ff, d))
    return (("wi", d, d_ff), ("wo", d_ff, d))


def mlp_draws(cfg, lead, d_ff: int | None = None) -> list[LeafDraw]:
    """A feed-forward block's projections stacked on ``lead``, in draw
    order."""
    return [LeafDraw(name, tuple(lead) + (k, n), fan_in=k)
            for name, k, n in ffn_projections(cfg, d_ff or cfg.d_ff)]


def init_mlp(generator: torch.Generator, cfg, init_fn, *, device, n_layers: int,
             d_ff: int | None = None) -> dict:
    """``n_layers`` stacked feed-forward blocks (:func:`mlp_draws`)."""
    return draw_leaves(mlp_draws(cfg, (n_layers,), d_ff), generator, init_fn, device=device)


def mlp(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        g = apply_linear(params["w_gate"], x)
        u = apply_linear(params["w_up"], x)
        return apply_linear(params["w_down"], F.silu(g) * u)
    h = apply_linear(params["wi"], x)
    # jax.nn.gelu's default is the tanh approximation
    return apply_linear(params["wo"], F.gelu(h, approximate="tanh"))
