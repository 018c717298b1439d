"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch (the
reference's ``repro/models/moe.py``).

Dispatch is sort-based: assignments sorted by expert id, each given its
position in its expert, scattered into an (E, capacity, D) buffer, so only
the active rows are computed (E x C rows, E x C ~ tokens x k). Expert
weights are stacked (E, ...); a packed expert leaf runs all E experts in
one expert-batched K2 launch (``kernels.ops.binary_matmul_batched``), the
reference's ``jax.vmap`` of its kernel. The router stays full precision
and routes in f32 (its product rounded once from f64: :func:`route`).

Three orders are kept as the reference's, so routing and combine agree
on any device: the top k is read from a stable descending sort of the f32
probabilities (a tie goes to the lower expert index, as ``jax.lax.top_k``
breaks it; ``torch.topk`` promises no order on CUDA); the dispatch sort is
stable; and each token's k contributions are added in x's dtype, rounding
after each add, in the order the reference's scatter-add meets them (the
expert-sorted order), never through ``index_add_``, whose CUDA atomics
would make a bf16 sum differ run to run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_linear


def _expert_matmul(w, xe: torch.Tensor, dtype) -> torch.Tensor:
    """Batched over experts: (E, C, a) x (E, a, b) -> (E, C, b) in
    ``dtype``. ``w`` is a master tensor (a plain batched product) or a
    serving leaf, applied through its backend (``PackedLinear``: the
    expert-batched K2)."""
    if isinstance(w, torch.Tensor):
        return torch.einsum("eca,eab->ecb", xe, w.to(dtype))
    return apply_linear(w, xe).to(dtype)


def init_moe(generator: torch.Generator, cfg, init_fn, *, device, n_layers: int) -> dict:
    """``n_layers`` stacked MoE FFNs: the router (L, D, E) and the experts'
    projections (L, E, ...), in the reference's tree."""
    e, d, f, n = cfg.n_experts, cfg.d_model, cfg.d_ff, n_layers
    p = {"router": init_fn(generator, (n, d, e), fan_in=d, device=device)}
    if cfg.mlp_type == "glu":
        p["w_gate"] = init_fn(generator, (n, e, d, f), fan_in=d, device=device)
        p["w_up"] = init_fn(generator, (n, e, d, f), fan_in=d, device=device)
        p["w_down"] = init_fn(generator, (n, e, f, d), fan_in=f, device=device)
    else:
        p["wi"] = init_fn(generator, (n, e, d, f), fan_in=d, device=device)
        p["wo"] = init_fn(generator, (n, e, f, d), fan_in=f, device=device)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Rows per expert for ``n_tokens`` tokens: tokens x k x capacity_factor
    / E, rounded up to a multiple of 8 and at least 8 (a host int)."""
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / max(cfg.n_experts, 1))
    return max(8, -(-c // 8) * 8)


def route(cfg, router: torch.Tensor, xt: torch.Tensor):
    """Top-k routing of tokens xt (T, D), in f32: (probs (T, E), the top k's
    weights renormalised to sum 1 (T, k), their experts (T, k)), the k
    experts in descending probability, a tie to the lower index.

    The router product is summed in f64 and rounded to f32 once, so a
    token's logits do not depend on how many tokens share the call: an f32
    GEMM's summation order does (cuBLAS takes another kernel at T = 1), and
    a logit one ulp off may flip a near-tie expert, so a stream would differ
    from the same request decoded alone."""
    logits = (xt.to(torch.float64) @ router.to(torch.float64)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    topk_p, topk_e = ranked.values[:, :k], ranked.indices[:, :k]
    return probs, topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9), topk_e


def moe_ffn(cfg, params: dict, x: torch.Tensor):
    """x (B, S, D) -> (y (B, S, D), {"lb_loss", "dropped_frac"})."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    e = cfg.n_experts
    cap = capacity(cfg, t)
    xt = x.reshape(t, d)
    dev = x.device

    probs, topk_p, topk_e = route(cfg, params["router"], xt)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    e_flat = topk_e.reshape(-1)                                        # (T*k,)
    # a scatter of integer counts (torch.bincount reads its input's max on
    # the host, a sync a layer)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    me = torch.mean(probs, dim=0)
    ce = counts.to(torch.float32) / (t * k)
    lb_loss = e * torch.sum(me * ce)

    # --- dispatch: sort assignments by expert ---
    w_flat = topk_p.reshape(-1).to(x.dtype)
    tok_flat = torch.arange(t * k, device=dev) // k
    order = torch.sort(e_flat, stable=True).indices
    se, st, sw = e_flat[order], tok_flat[order], w_flat[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - starts[se]
    keep = pos < cap
    # the (E, cap, D) buffer flattened, plus one row past its end that
    # swallows the dropped assignments (the reference's per-expert row cap)
    row = torch.where(keep, se * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[row] = xt[st]
    xe = buf[: e * cap].view(e, cap, d)

    # --- expert FFN (batched over E; dense or bitpacked weights) ---
    if "w_gate" in params:
        g = _expert_matmul(params["w_gate"], xe, x.dtype)
        u = _expert_matmul(params["w_up"], xe, x.dtype)
        ye = _expert_matmul(params["w_down"], F.silu(g) * u, x.dtype)
    else:
        h = _expert_matmul(params["wi"], xe, x.dtype)
        # jax.nn.gelu's default is the tanh approximation
        ye = _expert_matmul(params["wo"], F.gelu(h, approximate="tanh"), x.dtype)

    # --- combine ---
    # a dropped assignment reads its expert's last row, weighted 0
    y_assign = ye.reshape(e * cap, d)[se * cap + torch.clamp(pos, max=cap - 1)]
    y_assign = y_assign * (sw * keep.to(x.dtype))[:, None]
    # each token's k sorted positions, ascending: the order of the
    # reference's scatter-add over the sorted assignments
    at = torch.empty_like(order)
    at[order] = torch.arange(t * k, device=dev)
    at = torch.sort(at.view(t, k), dim=-1).values
    y = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + y_assign[at[:, j]]
    # 1 - mean(keep) as the reference's XLA computes it: kept x f32(1 / n),
    # the mean's reciprocal product, contracted with the subtraction into
    # one rounding (an FMA), here exact in f64 and rounded once
    recip = torch.tensor(1.0 / (t * k), dtype=torch.float32).item()
    dropped = (1.0 - keep.sum().to(torch.float64) * recip).to(torch.float32)
    return y.reshape(b, s, d), {"lb_loss": lb_loss, "dropped_frac": dropped}
