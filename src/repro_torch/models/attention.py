"""Grouped-query attention with RoPE, sliding windows and a KV cache (the
reference's ``repro/models/attention.py``, single device).

Covers the dense LM family: GQA, sliding-window attention (h2o-danube-3),
QKV bias (qwen2.5), and the one-token decode path the serving engine runs
against the slot-addressed cache. ``flash_attention`` is the reference's
chunked online softmax in plain torch (the reference's is jnp, not a
Pallas kernel), used from ``FLASH_THRESHOLD`` tokens up.
``chunk_attention`` runs one slot's prefill chunk against that slot's
cache rows (chunked prefill).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import (LeafDraw, apply_linear, draw_leaves, filled,
                                       rope_cos_sin, rotate)

NEG_INF = -1e30

# Sequences at or above this length use the chunked online-softmax (flash)
# path, which keeps attention memory O(S * chunk) instead of O(S^2).
FLASH_THRESHOLD = 4096
FLASH_CHUNK = 1024


def attn_draws(cfg, lead) -> list[LeafDraw]:
    """Attention's leaves stacked on ``lead``, in draw order: ``w_qkv``
    (..., D, Q + 2 KV), ``w_o`` (..., Q, D) and, with the bias, ``b_qkv`` 0."""
    lead, qkv = tuple(lead), cfg.q_dim + 2 * cfg.kv_dim
    draws = [LeafDraw("w_qkv", lead + (cfg.d_model, qkv), fan_in=cfg.d_model),
             LeafDraw("w_o", lead + (cfg.q_dim, cfg.d_model), fan_in=cfg.q_dim)]
    if cfg.qkv_bias:
        draws.append(filled("b_qkv", lead + (qkv,)))
    return draws


def init_attn(generator: torch.Generator, cfg, init_fn, *, device, n_layers: int) -> dict:
    """``n_layers`` stacked attention blocks (:func:`attn_draws`)."""
    return draw_leaves(attn_draws(cfg, (n_layers,)), generator, init_fn, device=device)


def _split_qkv(cfg, qkv: torch.Tensor):
    q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    b, s = q.shape[:2]
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x if groups == 1 else torch.repeat_interleave(x, groups, dim=2)


def causal_mask(s_q: int, s_k: int, window: Optional[int], q_offset: int = 0,
                device=None) -> torch.Tensor:
    """(s_q, s_k) boolean mask, True = attend, with an optional sliding window."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= (qi - ki) < window
    return m


def flash_attention(q, k, v, *, window: Optional[int] = None, chunk_q: int = FLASH_CHUNK,
                    chunk_k: int = FLASH_CHUNK) -> torch.Tensor:
    """Causal chunked attention with an online softmax, as the reference's:
    q/k/v (B, S, H, hd), k/v already GQA-expanded; every (q block, k block)
    pair is computed, and masked blocks are discarded by the mask."""
    bsz, s, h, hd = q.shape
    nq, nk = s // chunk_q, s // chunk_k
    scale = hd ** -0.5
    qi = torch.arange(chunk_q, device=q.device)
    kj = torch.arange(chunk_k, device=q.device)
    out = []
    for i in range(nq):
        qb = q[:, i * chunk_q:(i + 1) * chunk_q]                 # (B, cq, H, hd)
        m = torch.full((bsz, h, chunk_q), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bsz, h, chunk_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bsz, h, chunk_q, hd), dtype=torch.float32, device=q.device)
        for j in range(nk):
            kb = k[:, j * chunk_k:(j + 1) * chunk_k]
            vb = v[:, j * chunk_k:(j + 1) * chunk_k]
            logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb).to(torch.float32) * scale
            qpos = i * chunk_q + qi[:, None]
            kpos = j * chunk_k + kj[None, :]
            msk = kpos <= qpos
            if window is not None:
                msk &= (qpos - kpos) < window
            logits = torch.where(msk[None, None], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vb).to(torch.float32)
            m = m_new
        ob = acc / torch.clamp(l[..., None], min=1e-30)
        out.append(ob.transpose(1, 2).to(qb.dtype))             # (B, cq, H, hd)
    return torch.cat(out, dim=1)


def _sdpa(cfg, q, k, v, s: int) -> torch.Tensor:
    """Dense attention below FLASH_THRESHOLD, flash at and above it."""
    if s >= FLASH_THRESHOLD and s % FLASH_CHUNK == 0:
        return flash_attention(q, k, v, window=cfg.sliding_window)
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    mask = causal_mask(s, s, cfg.sliding_window, device=q.device)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _qkv_rope(cfg, params: dict, x: torch.Tensor, positions: torch.Tensor):
    """q, k, v of x (B, S, D), q and k rotated by ``positions``."""
    qkv = apply_linear(params["w_qkv"], x, params.get("b_qkv"))
    q, k, v = _split_qkv(cfg, qkv)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def attention(cfg, params: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Full (training / prefill) self-attention. x: (B, S, D)."""
    return attention_with_cache_write(cfg, params, x, positions)[0]


def attention_with_cache_write(cfg, params: dict, x: torch.Tensor, positions: torch.Tensor):
    """Prefill: :func:`attention`, also returning the post-RoPE k and v
    before the GQA expansion, (B, S, KV, hd), to cache."""
    q, k, v = _qkv_rope(cfg, params, x, positions)
    groups = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(cfg, q, _repeat_kv(k, groups), _repeat_kv(v, groups), x.shape[1])
    out = out.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    return apply_linear(params["w_o"], out), k, v


def decode_attention(cfg, params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor):
    """One-token decode. x: (B, 1, D); caches (B, S_cache, KV, hd), written
    in place (the reference donates them); pos (B,) int32, the tokens each
    row has seen. Returns (out, k_cache, v_cache).

    For sliding-window archs the cache length is the window and writes wrap
    (a ring); masking is by token age, which the wrap does not change. The
    write stores the new k and v at one index per row (a selection, no
    arithmetic on cache values, as the reference's one-hot select)."""
    b = x.shape[0]
    s_cache = k_cache.shape[1]
    q, k, v = _qkv_rope(cfg, params, x, pos[:, None])
    pos64 = pos.to(torch.int64)
    write_idx = pos64 % s_cache if cfg.sliding_window else torch.clamp(pos64, max=s_cache - 1)
    rows = torch.arange(b, device=x.device)
    k_cache.index_put_((rows, write_idx), k[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, write_idx), v[:, 0].to(v_cache.dtype))

    # grouped attention without expanding the cache: q (B, KV, G, hd)
    # against the cache (B, S, KV, hd)
    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q[:, 0].reshape(b, cfg.n_kv_heads, groups, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bngd,bsnd->bngs", qg,
                          k_cache.to(x.dtype)).to(torch.float32) * scale
    slots = torch.arange(s_cache, device=x.device)[None, :]
    if cfg.sliding_window:
        # the slot holds token (pos - age); valid if age < min(window, pos + 1)
        age = (write_idx[:, None] - slots) % s_cache
        valid = age < torch.clamp(pos64[:, None] + 1, max=cfg.sliding_window)
    else:
        valid = slots <= pos64[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bngs,bsnd->bngd", probs, v_cache.to(x.dtype))
    return apply_linear(params["w_o"], out.reshape(b, 1, cfg.q_dim)), k_cache, v_cache


def chunk_attention(cfg, params: dict, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, slot: int, offset: int):
    """Chunked-prefill attention: C prompt tokens of one slot against the
    slot-addressed cache. x: (1, C, D); caches (n_slots, S_cache, KV, hd),
    written in place; ``offset`` is the number of prompt tokens already in
    the slot. Returns (out, k_cache, v_cache).

    The chunk's queries attend over the slot's pre-write cache rows plus the
    chunk's own K/V under one softmax: cache lanes are masked to the real
    pre-offset tokens (by token age for ring caches), chunk lanes causally
    within the chunk (and the window). The chunk's K/V are written only
    after attention, since writing first would evict ring tokens still
    inside earlier in-chunk queries' windows; ring caches therefore need
    C <= S_cache, and linear caches offset + C <= S_cache (where the
    reference's ``dynamic_update_slice`` would clamp the start)."""
    c = x.shape[1]
    s_cache = k_cache.shape[1]
    positions = offset + torch.arange(c, dtype=torch.int32, device=x.device)
    q, k, v = _qkv_rope(cfg, params, x, positions)           # (1, C, H/KV, hd)
    k_ctx, v_ctx = k_cache[slot:slot + 1], v_cache[slot:slot + 1]

    # grouped attention without expanding the cache, as decode_attention:
    # q (1, C, KV, G, hd) against (1, S + C, KV, hd)
    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(1, c, cfg.n_kv_heads, groups, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    k_all = torch.cat([k_ctx.to(x.dtype), k.to(x.dtype)], dim=1)
    v_all = torch.cat([v_ctx.to(x.dtype), v.to(x.dtype)], dim=1)
    logits = torch.einsum("bcngd,bsnd->bngcs", qg, k_all).to(torch.float32) * scale

    qi = torch.arange(c, device=x.device)
    si = torch.arange(s_cache, device=x.device)
    p_q = offset + qi
    if cfg.sliding_window:
        # ring slot s holds token t_s = (offset-1) - ((offset-1-s) % S); a
        # negative t_s was never written for this prefix
        t_s = (offset - 1) - ((offset - 1 - si) % s_cache)
        ctx_valid = (t_s[None, :] >= 0) & (p_q[:, None] - t_s[None, :] < cfg.sliding_window)
    else:
        ctx_valid = (si[None, :] < offset).expand(c, s_cache)
    chunk_valid = qi[None, :] <= qi[:, None]
    if cfg.sliding_window:
        chunk_valid &= (qi[:, None] - qi[None, :]) < cfg.sliding_window
    valid = torch.cat([ctx_valid, chunk_valid], dim=1)          # (C, S + C)
    logits = torch.where(valid[None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bngcs,bsnd->bcngd", probs, v_all).reshape(1, c, cfg.q_dim)

    # post-attention write of the chunk's K/V into the slot's rows
    if cfg.sliding_window:
        if c > s_cache:
            raise ValueError(f"a ring cache of {s_cache} rows takes chunks of at most "
                             f"{s_cache} tokens, got {c}")
        rows = (offset + torch.arange(c, device=x.device)) % s_cache
    else:
        if offset + c > s_cache:
            raise ValueError(f"chunk of {c} tokens at offset {offset} runs past the "
                             f"{s_cache}-row cache")
        rows = torch.arange(offset, offset + c, device=x.device)
    k_cache[slot].index_copy_(0, rows, k[0].to(k_cache.dtype))
    v_cache[slot].index_copy_(0, rows, v[0].to(v_cache.dtype))
    return apply_linear(params["w_o"], out), k_cache, v_cache


def cache_length(cfg, seq_len: int) -> int:
    """KV-cache length for an arch at a context of ``seq_len`` tokens."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len
