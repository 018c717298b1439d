"""Decoder stack of the LM families (the reference's
``repro/models/transformer.py``, its ``uniform`` template): every layer
attention + FFN, dense (starcoder2, qwen2.5, h2o-danube-3, deepseek-coder)
or MoE (moonshot / Moonlight, grok: ``models.moe`` on every layer).

Layers are stacked on a leading axis, as the reference stacks them for
``lax.scan``: the forward passes loop over layer ``i`` and slice every
stacked leaf (``leaf[i]``, for tensors and packed leaves alike). Forward
passes are binarization-agnostic: a projection leaf may be a master
tensor, a ``PackedLinear`` (K2) or an ``XnorLinear`` (K3 + K4).

The decode cache is slot-addressed and long-lived: ``decode_step`` and
``cache_insert`` write its tensors in place, where the reference donates
them to a jitted call, and return the cache dict; ``prefill_chunk``
advances one slot's prefill by a chunk the same way. The SSM, hybrid and
frontend families wait for ROADMAP queue 1 item 6b and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models.layers import embed_lookup, lm_init, rms_norm

_ITEM_6B = "ROADMAP queue 1 item 6b"


def require_uniform(cfg) -> None:
    """Raises unless ``cfg`` runs the uniform template on tokens (the dense
    and MoE families), the one the port runs."""
    if cfg.family == "ssm" or cfg.is_hybrid or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet ({_ITEM_6B}); "
            f"the port runs the dense and MoE families")


def init_lm(cfg, generator: torch.Generator, *, device) -> dict:
    """Master weights drawn from ``generator`` (which must live on
    ``device``), f32, in the reference's tree: ``embed``, ``final_norm``,
    ``lm_head`` and the stacked ``layers``: ``moe`` in place of ``mlp``
    when every layer is an MoE layer, as in the reference."""
    require_uniform(cfg)
    n = cfg.n_layers
    params: dict[str, Any] = {
        "embed": {"embedding": lm_init(generator, (cfg.vocab_size, cfg.d_model),
                                       fan_in=cfg.d_model, device=device)},
        "final_norm": {"scale": torch.zeros((cfg.d_model,), device=device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": lm_init(generator, (cfg.d_model, cfg.vocab_size),
                                               device=device)}
    params["layers"] = {
        "attn": A.init_attn(generator, cfg, lm_init, device=device, n_layers=n),
        "ln1": {"scale": torch.zeros((n, cfg.d_model), device=device)},
        "ln2": {"scale": torch.zeros((n, cfg.d_model), device=device)},
    }
    if cfg.n_experts and cfg.moe_every == 1:
        params["layers"]["moe"] = MOE.init_moe(generator, cfg, lm_init, device=device,
                                               n_layers=n)
    else:
        params["layers"]["mlp"] = M.init_mlp(generator, cfg, lm_init, device=device,
                                             n_layers=n)
    return params


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked ``layers`` tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _embed_in(cfg, params: dict, tokens_or_embeds: torch.Tensor) -> torch.Tensor:
    if not tokens_or_embeds.is_floating_point():
        return embed_lookup(params["embed"]["embedding"], tokens_or_embeds,
                            cfg.activation_dtype)
    return tokens_or_embeds.to(cfg.activation_dtype)


def _head_out(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the dense head; the f32 head master is cast to the
    activation dtype every call, as the reference casts it."""
    x = rms_norm(x, params["final_norm"]["scale"])
    if cfg.tie_embeddings:
        w = params["embed"]["embedding"].to(x.dtype).T
    else:
        w = params["lm_head"]["kernel"].to(x.dtype)
    return torch.matmul(x, w)


def _block(cfg, lp: dict, x: torch.Tensor, attend, aux: list | None = None) -> torch.Tensor:
    """One pre-norm layer: x + attn(norm x), then + ffn(norm x), the FFN an
    MoE layer's where the layer has ``moe`` (its aux dict appended to
    ``aux`` when given), else the MLP."""
    x = x + attend(lp["attn"], rms_norm(x, lp["ln1"]["scale"]))
    h = rms_norm(x, lp["ln2"]["scale"])
    if "moe" in lp:
        y, moe_aux = MOE.moe_ffn(cfg, lp["moe"], h)
        if aux is not None:
            aux.append(moe_aux)
        return x + y
    return x + M.mlp(cfg, lp["mlp"], h)


def forward(cfg, params: dict, tokens_or_embeds: torch.Tensor):
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), aux), aux's
    ``lb_loss`` the MoE layers' load-balance losses summed (0 when dense)."""
    require_uniform(cfg)
    x = _embed_in(cfg, params, tokens_or_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux: list[dict] = []
    for i in range(cfg.n_layers):
        x = _block(cfg, layer_params(params["layers"], i), x,
                   lambda p, h: A.attention(cfg, p, h, positions), aux)
    lb = torch.zeros((), device=x.device)
    for a in aux:
        lb = lb + a["lb_loss"]
    return _head_out(cfg, params, x), {"lb_loss": lb}


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, context_len: int, dtype=None, *, device) -> dict:
    """Zeroed decode cache for a context of ``context_len`` tokens:
    ``pos`` (B,) int32 and ``k``/``v`` (L, B, S_kv, KV, hd)."""
    require_uniform(cfg)
    dtype = dtype or cfg.activation_dtype
    s_kv = A.cache_length(cfg, context_len)
    shape = (cfg.n_layers, batch, s_kv, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_slot_axes(cfg) -> dict[str, int]:
    """Slot (batch) axis of every decode-cache entry: each request owns one
    index along these axes for its lifetime."""
    require_uniform(cfg)
    return {"pos": 0, "k": 1, "v": 1}


def cache_insert(cfg, cache: dict, one: dict, slot: int) -> dict:
    """Copies a batch-1 cache ``one`` (a prefill with the same context
    length) into ``cache`` at slot index ``slot``, in place; the other
    slots are untouched. Returns ``cache``."""
    axes = cache_slot_axes(cfg)
    if set(axes) != set(cache):
        raise ValueError(
            f"cache_slot_axes is out of sync with the cache layout: axes cover "
            f"{sorted(axes)}, cache has {sorted(cache)} — an entry left out would "
            f"silently keep the slot's previous occupant")
    for name, axis in axes.items():
        upd = one[name]
        if upd.shape[axis] != 1:
            raise ValueError(f"cache_insert expects a batch-1 cache; {name!r} has "
                             f"{upd.shape[axis]} slots on axis {axis}")
        cache[name].narrow(axis, slot, 1).copy_(upd.to(cache[name].dtype))
    return cache


def cache_extract(cfg, cache: dict, slot: int) -> dict:
    """A batch-1 copy of one slot's cache rows (the inverse of
    :func:`cache_insert`)."""
    return {name: cache[name].narrow(axis, slot, 1).clone()
            for name, axis in cache_slot_axes(cfg).items()}


def cache_keep(cfg, old: dict, new: dict, keep: torch.Tensor) -> dict:
    """Per-slot merge: slots where ``keep`` (bool (n_slots,)) holds keep
    ``old``'s position counter, the rest take ``new``'s. Only state a
    pending prefill chunk cannot rewrite is re-selected (for this family,
    ``pos``); the K/V buffers pass through, as in the reference."""
    out = dict(new)
    for name, axis in cache_slot_axes(cfg).items():
        if name not in ("pos", "ssm", "conv"):
            continue
        shape = [1] * old[name].ndim
        shape[axis] = old[name].shape[axis]
        out[name] = torch.where(keep.reshape(shape), old[name], new[name])
    return out


def prefill_chunk(cfg, params: dict, cache: dict, tokens: torch.Tensor, slot: int,
                  offset: int):
    """Advances one slot's prefill by a chunk of C prompt tokens: tokens
    (1, C), ``offset`` the prompt tokens already in the slot. Attention
    reads the slot's pre-write rows, masked to what a whole-prompt prefill
    would see, and writes the chunk's K/V in place (``A.chunk_attention``).
    Returns (last-token logits (1, V), cache) with a new ``pos`` whose
    ``pos[slot]`` is ``offset + C``, set absolutely; the old ``pos`` tensor
    is left as it was."""
    require_uniform(cfg)
    x = _embed_in(cfg, params, tokens)
    c = x.shape[1]
    pos = cache["pos"].clone()
    pos[slot] = offset + c
    for i in range(cfg.n_layers):
        kc, vc = cache["k"][i], cache["v"][i]
        x = _block(cfg, layer_params(params["layers"], i), x,
                   lambda p, h: A.chunk_attention(cfg, p, h, kc, vc, slot, offset)[0])
    return _head_out(cfg, params, x[:, -1:])[:, -1], dict(cache, pos=pos)


def decode_step(cfg, params: dict, cache: dict, tokens_or_embeds: torch.Tensor):
    """One decode step for the whole batch: tokens (B, 1) ->
    (logits (B, V), cache), the cache's K/V written in place and ``pos``
    advanced by one."""
    require_uniform(cfg)
    x = _embed_in(cfg, params, tokens_or_embeds)
    pos = cache["pos"]
    for i in range(cfg.n_layers):
        kc, vc = cache["k"][i], cache["v"][i]
        x = _block(cfg, layer_params(params["layers"], i), x,
                   lambda p, h: A.decode_attention(cfg, p, h, kc, vc, pos)[0])
    return _head_out(cfg, params, x)[:, -1], dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# prefill: full context -> (last-token logits, populated cache)
# ---------------------------------------------------------------------------

def _to_cache_layout(cfg, k: torch.Tensor, s: int, s_kv: int) -> torch.Tensor:
    """(B, S, KV, hd) prefill keys -> a ring or linear cache of length s_kv.
    The token at absolute position p lives at slot p % s_kv (ring, sliding
    window) or p (linear), as ``decode_attention`` reads it."""
    if cfg.sliding_window and s > s_kv:
        return torch.roll(k[:, -s_kv:], shifts=(s - s_kv) % s_kv, dims=1)
    if s < s_kv:
        return F.pad(k, (0, 0) * (k.ndim - 2) + (0, s_kv - s))
    return k


def prefill(cfg, params: dict, tokens_or_embeds: torch.Tensor, max_len: int | None = None):
    """Prefill ``s`` context tokens -> (last-token logits (B, V), cache),
    the cache sized for ``max_len`` positions (default ``s + 1``, so one
    decode step fits)."""
    require_uniform(cfg)
    x = _embed_in(cfg, params, tokens_or_embeds)
    bsz, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    s_kv = A.cache_length(cfg, max_len if max_len is not None else s + 1)
    ks, vs = [], []

    def attend(p, h):
        y, k, v = A.attention_with_cache_write(cfg, p, h, positions)
        ks.append(_to_cache_layout(cfg, k.to(cfg.activation_dtype), s, s_kv))
        vs.append(_to_cache_layout(cfg, v.to(cfg.activation_dtype), s, s_kv))
        return y

    for i in range(cfg.n_layers):
        x = _block(cfg, layer_params(params["layers"], i), x, attend)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.full((bsz,), s, dtype=torch.int32, device=x.device)}
    return _head_out(cfg, params, x)[:, -1], cache
