"""Mamba2 (SSD, state-space duality) mixer: the chunked-scan form and the
O(1)-state decode form (the reference's ``repro/models/ssm.py``).

The minimal SSD formulation of Dao & Gu (arXiv:2405.21060): the sequence is
split into chunks; within a chunk the quadratic dual form runs (an
attention-like product masked by the decay kernel), and an explicit loop
over the chunks carries the (H, P, N) state across them. n_groups = 1 (B and
C shared across heads). A depthwise causal conv precedes the SSM over the
[x, B, C] channels.

Binarization applies to ``in_proj`` / ``out_proj`` only: they go through
``apply_linear``, so the plan's backend serves them (K2 for ``packed``, K3 +
K4 for ``xnor``). ``A_log``, ``dt_bias``, ``D``, ``conv`` and the gated
RMSNorm stay full precision. The reference's SSD is plain ``jnp.einsum``
and ``lax.scan`` outside any Pallas kernel, so it is plain torch here.

A served slot's bits must not depend on how many slots share a call, and
torch's f32 reductions (cuBLAS GEMMs, CUDA sums) pick their order by shape.
So every contraction of the SSD and of the decode step (over the chunk, the
state and the conv taps) is summed in f64 from the f32 operands and rounded
to f32 once, or is a fixed sequential f32 sum (the conv taps), as the
port's ``rms_norm`` and MoE router are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import LeafDraw, apply_linear, draw_leaves, filled, rms_norm

NEG_EXP = -1e30       # the masked exponent of the intra-chunk decay


def ssm_draws(cfg, lead) -> list[LeafDraw]:
    """A mixer's leaves stacked on ``lead``, in draw order: ``conv``
    (..., W, di + 2 n) 0.1 randn, ``in_proj`` (..., d, 2 di + 2 n + h),
    ``out_proj`` (..., di, d), then ``A_log`` log(linspace(1, 16, h)),
    ``dt_bias`` 0, ``D`` 1 and ``norm_scale`` 0, which draw nothing."""
    lead = tuple(lead)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv = lead + (cfg.ssm_conv_width, di + 2 * n)
    return [
        LeafDraw("conv", conv,
                 whole=lambda g, dev: 0.1 * torch.randn(conv, generator=g, device=dev)),
        LeafDraw("in_proj", lead + (d, 2 * di + 2 * n + h), fan_in=d),
        LeafDraw("out_proj", lead + (di, d), fan_in=di),
        LeafDraw("A_log", lead + (h,),
                 whole=lambda g, dev: torch.log(torch.linspace(1.0, 16.0, h, device=dev)
                                                ).repeat(*lead, 1)),
        filled("dt_bias", lead + (h,)),
        filled("D", lead + (h,), 1.0),
        filled("norm_scale", lead + (di,)),
    ]


def init_ssm(generator: torch.Generator, cfg, init_fn, *, device, n_layers: int) -> dict:
    """``n_layers`` stacked mixers in the reference's tree (:func:`ssm_draws`)."""
    return draw_leaves(ssm_draws(cfg, (n_layers,)), generator, init_fn, device=device)


def _split_proj(cfg, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) along the last axis."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x past its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_taps(pad: torch.Tensor, w, s: int) -> torch.Tensor:
    """sum_i pad[:, i:i + s] * w[i], in f32, summed tap by tap in order. On
    a mesh group's channel shards (``w`` a ``ModelShards`` split on its last
    dim) each position sums its channel range's taps in the same order and
    the ranges are gathered: a depthwise conv is per channel, so the bits
    are the unsharded call's."""
    if isinstance(w, SH.ModelShards):
        outs, start = [], 0
        for part in w.parts:
            c = part.shape[-1]
            outs.append(_conv_taps(pad[..., start:start + c].to(part.device), part, s))
            start += c
        return SH.all_gather(outs, -1, pad.device)
    out = torch.zeros(pad.shape[:1] + (s,) + pad.shape[2:], dtype=torch.float32,
                      device=pad.device)
    for i in range(w.shape[0]):
        out = out + pad[:, i:i + s].to(torch.float32) * w[i].to(torch.float32)
    return out


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, history=None) -> torch.Tensor:
    """Depthwise causal conv then ``silu``, xbc: (B, S, C), w: (W, C).

    ``history`` is an optional (B, W-1, C) window of the raw pre-conv
    channels before ``xbc`` (a decode ``conv_state``); ``None`` means the
    start of the sequence, zeros."""
    width = (w.parts[0] if isinstance(w, SH.ModelShards) else w).shape[0]
    if history is None:
        pad = F.pad(xbc, (0, 0, width - 1, 0))
    else:
        pad = torch.cat([history.to(xbc.dtype), xbc], dim=1)
    return F.silu(_conv_taps(pad, w, xbc.shape[1])).to(xbc.dtype)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) after softplus; a: (H,) negative decay;
    b_mat / c_mat: (B, S, N); ``init_state`` an optional (B, H, P, N)
    carried-in state (``None``: zeros). Returns y (B, S, H, P) in x's dtype
    and the final state (B, H, P, N) f32. Computed in f64 from the f32
    values and rounded once (the module's docstring)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, f"seq {s} not divisible by chunk {chunk}"
    f64 = torch.float64

    xc = x.to(f64).reshape(bsz, nc, chunk, h, p)
    dtc = dt.to(f64).reshape(bsz, nc, chunk, h)
    bc = b_mat.to(f64).reshape(bsz, nc, chunk, n)
    cc = c_mat.to(f64).reshape(bsz, nc, chunk, n)

    da = dtc * a.to(f64)                                    # (B, nc, Q, H) log-decay
    cum = torch.cumsum(da, dim=2)                           # inclusive

    # intra-chunk (the dual, quadratic form):
    # L[i, j] = exp(cum_i - cum_j) for i >= j, else 0; the exponent is masked
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B, nc, Q, Q, H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask[:, :, None], li, torch.full_like(li, NEG_EXP)))
    cb = torch.matmul(cc, bc.transpose(-1, -2))              # (B, nc, Q, Q)
    xdt = xc * dtc[..., None]                                # (B, nc, Q, H, P)
    lw = (cb[..., None] * decay).permute(0, 1, 4, 2, 3)      # (B, nc, H, Qi, Qj)
    y_intra = torch.matmul(lw, xdt.permute(0, 1, 3, 2, 4))   # (B, nc, H, Qi, P)

    # chunk states: the chunk's inputs decayed to its end
    seg_end = cum[:, :, -1:, :]                              # (B, nc, 1, H)
    state_w = torch.exp(seg_end - cum)                       # (B, nc, Q, H)
    xw = (xdt * state_w[..., None]).permute(0, 1, 3, 4, 2)   # (B, nc, H, P, Q)
    states = torch.matmul(xw, bc[:, :, None])                # (B, nc, H, P, N)

    # inter-chunk recurrence, the state at each chunk's start
    chunk_decay = torch.exp(seg_end[:, :, 0, :])             # (B, nc, H)
    h_prev = (torch.zeros((bsz, h, p, n), dtype=f64, device=x.device) if init_state is None
              else init_state.to(f64))
    h_before = []
    for c in range(nc):
        h_before.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(h_before, dim=1)                  # (B, nc, H, P, N)

    # inter-chunk output: y_i += C_i . h_chunkstart * exp(cum_i)
    y_inter = torch.matmul(h_before, cc[:, :, None].transpose(-1, -2))   # (B, nc, H, P, Qi)
    y_inter = y_inter.permute(0, 1, 2, 4, 3) * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y.to(torch.float32).to(x.dtype), h_prev.to(torch.float32)


def ssm_forward(cfg, params: dict, x: torch.Tensor, chunk: int = 128,
                return_state: bool = False, initial_state=None, conv_state=None):
    """Full-sequence Mamba2 mixer, x: (B, S, D) -> (B, S, D).

    ``initial_state`` (B, H, P, N) and ``conv_state`` (B, W-1, conv_dim)
    continue a partly consumed sequence (chunked prefill): the scan starts
    from ``initial_state`` and the conv sees ``conv_state`` as its left
    context; both default to the start of the sequence. With
    ``return_state`` returns (out, final state, conv tail), the tail the
    last W-1 raw pre-conv rows (W-1 long with a ``conv_state``, even for
    a chunk shorter than the conv width)."""
    bsz, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    tail = cfg.ssm_conv_width - 1

    z, xi, b_mat, c_mat, dt = _split_proj(cfg, apply_linear(params["in_proj"], x))
    xbc_raw = torch.cat([xi, b_mat, c_mat], dim=-1)
    if conv_state is None:
        conv_tail = xbc_raw[:, s - tail:]
    else:
        window = torch.cat([conv_state.to(xbc_raw.dtype), xbc_raw], dim=1)
        conv_tail = window[:, window.shape[1] - tail:]
    xbc = _causal_conv(xbc_raw, params["conv"], history=conv_state)
    xi, b_mat, c_mat = torch.split(xbc, [di, n, n], dim=-1)

    dt = _softplus(dt.to(torch.float32) + params["dt_bias"].to(torch.float32))
    a = -torch.exp(params["A_log"].to(torch.float32))
    xh = xi.reshape(bsz, s, h, p)

    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        xs, dts = F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bs, cs = F.pad(b_mat, (0, 0, 0, pad)), F.pad(c_mat, (0, 0, 0, pad))
    else:
        xs, dts, bs, cs = xh, dt, b_mat, c_mat
    y, state = ssd_chunked(xs, dts, a, bs, cs, chunk, init_state=initial_state)
    y = y[:, :s]

    y = y + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)            # the gate
    y = rms_norm(y, params["norm_scale"])
    out = apply_linear(params["out_proj"], y)
    if return_state:
        return out, state, conv_tail
    return out


def ssm_decode_step(cfg, params: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                    conv_state: torch.Tensor):
    """One-token decode. x: (B, 1, D); ssm_state: (B, H, P, N) f32;
    conv_state: (B, W-1, conv_dim). Returns (out, ssm_state, conv_state),
    the states new tensors."""
    bsz = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32

    z, xi, b_mat, c_mat, dt = _split_proj(cfg, apply_linear(params["in_proj"], x)[:, 0])
    xbc_new = torch.cat([xi, b_mat, c_mat], dim=-1)             # (B, conv_dim)
    window = torch.cat([conv_state.to(xbc_new.dtype), xbc_new[:, None]], dim=1)
    xbc = F.silu(_conv_taps(window, params["conv"], 1)[:, 0]).to(x.dtype)
    xi, b_mat, c_mat = torch.split(xbc, [di, n, n], dim=-1)

    dt = _softplus(dt.to(f32) + params["dt_bias"].to(f32))      # (B, H)
    a = -torch.exp(params["A_log"].to(f32))                     # (H,)
    da = torch.exp(dt * a[None, :])
    xh = xi.reshape(bsz, h, p).to(f32)
    dbx = (dt[:, :, None] * xh)[..., None] * b_mat.to(f32)[:, None, None, :]
    new_state = ssm_state * da[..., None, None] + dbx           # (B, H, P, N)
    y = torch.matmul(new_state.to(torch.float64),
                     c_mat.to(torch.float64)[:, None, :, None])[..., 0].to(f32)
    y = y + xh * params["D"].to(f32)[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = y * F.silu(z.to(f32)).to(x.dtype)[:, None, :]
    y = rms_norm(y, params["norm_scale"])
    return apply_linear(params["out_proj"], y), new_state, window[:, 1:]


def ssd_reference(x, dt, a, b_mat, c_mat):
    """The plain per-step recurrence, in f32 (tests only): (y (B, S, H, P),
    final state (B, H, P, N))."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    f32 = torch.float32
    x, dt, b_mat, c_mat = (t.to(f32) for t in (x, dt, b_mat, c_mat))
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a)                            # (B, H)
        dbx = (dt[:, t, :, None] * x[:, t])[..., None] * b_mat[:, t, None, None, :]
        state = state * da[..., None, None] + dbx
        ys.append(torch.einsum("bn,bhpn->bhp", c_mat[:, t], state))
    return torch.stack(ys, dim=1), state

