"""Decoder stack of the LM families (the reference's
``repro/models/transformer.py``): its ``uniform`` template, every layer
attention + FFN, dense (starcoder2, qwen2.5, h2o-danube-3, deepseek-coder)
or MoE (moonshot / Moonlight, grok: ``models.moe`` on every layer), and its
``ssm`` template, every layer a Mamba2 mixer (mamba2-130m: ``models.ssm``).

Layers are stacked on a leading axis, as the reference stacks them for
``lax.scan``: the forward passes loop over layer ``i`` and slice every
stacked leaf (``leaf[i]``, for tensors and packed leaves alike). Forward
passes are binarization-agnostic: a projection leaf may be a master
tensor, a ``PackedLinear`` (K2) or an ``XnorLinear`` (K3 + K4).

The decode cache is slot-addressed and long-lived: ``decode_step`` and
``cache_insert`` write its tensors in place, where the reference donates
them to a jitted call, and return the cache dict; ``prefill_chunk``
advances one slot's prefill by a chunk the same way. The SSM family's
recurrent ``ssm`` and ``conv`` states are the exception: ``decode_step``
returns them anew (a multiplicative update that the fused decode + chunk
step must be able to undo for a mid-prefill slot, :func:`cache_keep`),
and ``prefill_chunk`` writes its slot's rows in place.

The ``hybrid`` template (jamba-1.5-large) runs periods of ``attn_period``
layers: in each, layer ``attn_period // 2`` is attention and the others
Mamba2 mixers, and layer j's FFN is MoE where ``cfg.moe_layer(j)``, else
the MLP. Its leaves stack (n_per, ...) and, within a period, the mixers,
MLPs and MoE FFNs once more ((n_per, 7, ...) at jamba's period of 8). Its
cache holds both kinds of state: K/V of the attention layers, written in
place, and the mixers' ``ssm`` and ``conv``, returned anew by
``decode_step``. Its masters are drawn one (K, N) matrix at a time
(:func:`lm_draws`), so a packed serve can pack each matrix as it is drawn
(``ExecutionPlan.pack_drawn``) and never hold the whole master tree. The
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
from repro_torch.models import ssm as S
from repro_torch.models.layers import (LeafDraw, embed_lookup, filled, lm_init, rms_norm,
                                       tree_from_paths)

_ITEM_6B = "ROADMAP queue 1 item 6b"

# The cache entries ``decode_step`` returns anew, where it writes the rest in
# place; :func:`cache_keep` re-selects them for the slots a fused step keeps.
STEP_STATE = ("pos", "ssm", "conv")


def require_ported(cfg) -> None:
    """Raises unless ``cfg`` runs a template the port runs on tokens: the
    uniform one (the dense and MoE families), the SSM one or the hybrid one,
    whose depth must then be a positive multiple of its period (the
    reference's ``n_layers // attn_period`` would drop the rest)."""
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet ({_ITEM_6B}); "
            f"the port runs the dense, MoE, SSM and hybrid families")
    if cfg.is_hybrid and (cfg.n_layers < cfg.attn_period or cfg.n_layers % cfg.attn_period):
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a positive multiple of "
                         f"the hybrid period attn_period={cfg.attn_period}")


def _hybrid_counts(cfg) -> tuple[int, int, int, int]:
    """(periods, mixers, MoE FFNs, MLPs) of the hybrid template: mixers,
    MoE FFNs and MLPs counted within a period."""
    per = cfg.attn_period
    n_moe = sum(cfg.moe_layer(j) for j in range(per))
    return cfg.n_layers // per, per - 1, n_moe, per - n_moe


def _top_draws(cfg) -> list[LeafDraw]:
    """The leaves outside ``layers``, in draw order: ``embed``,
    ``final_norm`` and, for an untied head, ``lm_head``, each drawn whole."""
    d, v = cfg.d_model, cfg.vocab_size
    draws = [LeafDraw("embed/embedding", (v, d),
                      whole=lambda g, dev: lm_init(g, (v, d), fan_in=d, device=dev)),
             filled("final_norm/scale", (d,))]
    if not cfg.tie_embeddings:
        draws.append(LeafDraw("lm_head/kernel", (d, v),
                              whole=lambda g, dev: lm_init(g, (d, v), device=dev)))
    return draws


def lm_draws(cfg) -> list[LeafDraw]:
    """The draw order of a family whose masters are drawn one (K, N) matrix
    at a time, the hybrid's (every other family draws its stacked leaves
    whole, :func:`init_lm`): ``embed``, ``final_norm``, ``lm_head``
    (untied heads), then ``layers``' ``attn`` (n_per, ...), ``mamba``
    (n_per, mixers, ...), ``mlp`` (n_per, MLPs, ...) and ``moe`` (n_per,
    MoE FFNs, ...), each in its module's own draw order (``attn_draws``,
    ``ssm_draws``, ``mlp_draws``, ``moe_draws``), then ``ln1`` and ``ln2``.
    Every stacked projection is drawn one (K, N) matrix at a time,
    row-major over its leading dims; the embedding, head, routers and the
    mixers' conv are drawn whole; norms, biases, ``A_log``, ``dt_bias``,
    ``D`` and ``norm_scale`` draw nothing. The order is the port's own: its
    masters come from a torch.Generator, the reference's from a key, so
    parity tests carry the reference's masters across
    (``interop.from_jax_tree``)."""
    require_ported(cfg)
    if not cfg.is_hybrid:
        raise ValueError(f"{cfg.name}: the {cfg.family} family draws its stacked leaves "
                         f"whole (init_lm); only the hybrid draws matrix by matrix")
    n_per, n_mix, n_moe, n_mlp = _hybrid_counts(cfg)
    draws = _top_draws(cfg)
    for name, module in (("attn", A.attn_draws(cfg, (n_per,))),
                         ("mamba", S.ssm_draws(cfg, (n_per, n_mix))),
                         ("mlp", M.mlp_draws(cfg, (n_per, n_mlp))),
                         ("moe", MOE.moe_draws(cfg, (n_per, n_moe)))):
        draws += [d.under(f"layers/{name}") for d in module]
    return draws + [filled(f"layers/{ln}/scale", (n_per, cfg.attn_period, cfg.d_model))
                    for ln in ("ln1", "ln2")]


def lm_shapes(cfg) -> dict:
    """A twin of :func:`init_lm`'s tree on the ``meta`` device, for a family
    with :func:`lm_draws`: every leaf's shape and no storage, enough to
    compile a plan (``compile_plan`` reads paths and shapes only)."""
    return tree_from_paths((d.path, torch.empty(d.shape, device="meta")) for d in lm_draws(cfg))


def init_lm(cfg, generator: torch.Generator, *, device) -> dict:
    """Master weights drawn from ``generator`` (which must live on
    ``device``), f32, in the reference's tree: ``embed``, ``final_norm``,
    ``lm_head`` (untied heads) and the stacked ``layers``: ``moe`` in place
    of ``mlp`` when every layer is an MoE layer, and ``ssm`` and ``ln1``
    alone for the SSM family, as in the reference. The hybrid's leaves are
    drawn in :func:`lm_draws`'s order, each stacked projection one (K, N)
    matrix at a time."""
    require_ported(cfg)
    if cfg.is_hybrid:
        return tree_from_paths((d.path, d.materialize(generator, device)) for d in lm_draws(cfg))
    n = cfg.n_layers
    params: dict[str, Any] = tree_from_paths((d.path, d.whole(generator, device))
                                             for d in _top_draws(cfg))
    if cfg.is_ssm_only:
        params["layers"] = {
            "ssm": S.init_ssm(generator, cfg, lm_init, device=device, n_layers=n),
            "ln1": {"scale": torch.zeros((n, cfg.d_model), device=device)},
        }
        return params
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


def _period(cfg, lp: dict, x: torch.Tensor, attend, mix, aux: list | None = None
            ) -> torch.Tensor:
    """One period of the hybrid template (``lp``: the period's slice of
    ``layers``). Layer j, pre-norm: x + mixer(norm x), the mixer attention
    (``attend(attn params, h)``) at j = attn_period // 2 and otherwise
    Mamba2 mixer mi of the period (``mix(mi, its params, h)``, mi counting
    the mixers in order); then x + ffn(norm x), the FFN the period's next
    MoE FFN where ``cfg.moe_layer(j)`` (its aux dict appended to ``aux``
    when given), else its next MLP."""
    attn_at = cfg.attn_period // 2
    mi = di = oi = 0
    for j in range(cfg.attn_period):
        h = rms_norm(x, lp["ln1"]["scale"][j])
        if j == attn_at:
            x = x + attend(lp["attn"], h)
        else:
            x = x + mix(mi, layer_params(lp["mamba"], mi), h)
            mi += 1
        h = rms_norm(x, lp["ln2"]["scale"][j])
        if cfg.moe_layer(j):
            y, moe_aux = MOE.moe_ffn(cfg, layer_params(lp["moe"], oi), h)
            oi += 1
            if aux is not None:
                aux.append(moe_aux)
        else:
            y = M.mlp(cfg, layer_params(lp["mlp"], di), h)
            di += 1
        x = x + y
    return x


def forward(cfg, params: dict, tokens_or_embeds: torch.Tensor):
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), aux), aux's
    ``lb_loss`` the MoE layers' load-balance losses summed (0 when dense)."""
    require_ported(cfg)
    x = _embed_in(cfg, params, tokens_or_embeds)
    if cfg.is_ssm_only:
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            x = x + S.ssm_forward(cfg, lp["ssm"], rms_norm(x, lp["ln1"]["scale"]))
        return _head_out(cfg, params, x), {"lb_loss": torch.zeros((), device=x.device)}
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux: list[dict] = []
    if cfg.is_hybrid:
        for p in range(_hybrid_counts(cfg)[0]):
            x = _period(cfg, layer_params(params["layers"], p), x,
                        lambda ap, h: A.attention(cfg, ap, h, positions),
                        lambda mi, mp, h: S.ssm_forward(cfg, mp, h), aux)
    else:
        for i in range(cfg.n_layers):
            x = _block(cfg, layer_params(params["layers"], i), x,
                       lambda ap, h: A.attention(cfg, ap, h, positions), aux)
    lb = torch.zeros((), device=x.device)
    for a in aux:
        lb = lb + a["lb_loss"]
    return _head_out(cfg, params, x), {"lb_loss": lb}


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, context_len: int, dtype=None, *, device) -> dict:
    """Zeroed decode cache for a context of ``context_len`` tokens:
    ``pos`` (B,) int32 and ``k``/``v`` (L, B, S_kv, KV, hd), or for the SSM
    family ``ssm`` (L, B, H, P, N) f32 and ``conv`` (L, B, W-1, conv_dim);
    the hybrid's ``k``/``v`` (n_per, B, S_kv, KV, hd), ``ssm`` (n_per, mixers,
    B, H, P, N) f32 and ``conv`` (n_per, mixers, B, W-1, conv_dim)."""
    require_ported(cfg)
    dtype = dtype or cfg.activation_dtype
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.is_ssm_only or cfg.is_hybrid:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        lead = ((cfg.n_layers,) if cfg.is_ssm_only else _hybrid_counts(cfg)[:2]) + (batch,)
        cache["ssm"] = torch.zeros(lead + (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros(lead + (cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                                    device=device)
        if cfg.is_ssm_only:
            return cache
    n_attn = _hybrid_counts(cfg)[0] if cfg.is_hybrid else cfg.n_layers
    shape = (n_attn, batch, A.cache_length(cfg, context_len), cfg.n_kv_heads, cfg.head_dim)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def cache_slot_axes(cfg) -> dict[str, int]:
    """Slot (batch) axis of every decode-cache entry: each request owns one
    index along these axes for its lifetime."""
    require_ported(cfg)
    if cfg.is_ssm_only:
        return {"pos": 0, "ssm": 1, "conv": 1}
    if cfg.is_hybrid:
        return {"pos": 0, "k": 1, "v": 1, "ssm": 2, "conv": 2}
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
    ``old``'s rows, the rest take ``new``'s. Only state a pending prefill
    chunk cannot rewrite is re-selected (``STEP_STATE``: the position
    counters, and the mixers' recurrent ``ssm`` and ``conv`` states, which a
    foreign decode would corrupt, each on its own slot axis); the K/V
    buffers pass through, as in the reference."""
    out = dict(new)
    for name, axis in cache_slot_axes(cfg).items():
        if name not in STEP_STATE:
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
    is left as it was.

    The SSM family's and the hybrid's mixers thread the slot's recurrent
    state and conv window through the chunk (``ssm_forward`` with
    ``chunk=C``) and write the slot's new rows in place; at ``offset`` 0 (a
    fresh prefill) the slot's resident rows belong to its previous occupant
    and read as zeros."""
    require_ported(cfg)
    x = _embed_in(cfg, params, tokens)
    c = x.shape[1]
    pos = cache["pos"].clone()
    pos[slot] = offset + c

    def chunk_mix(mp, h, ssm, conv):
        """One mixer's chunk on its cache rows ``ssm`` (B, H, P, N) and
        ``conv`` (B, W-1, conv_dim), the slot's rows written in place."""
        st0, cv0 = ssm[slot:slot + 1], conv[slot:slot + 1]
        if offset == 0:
            st0, cv0 = torch.zeros_like(st0), torch.zeros_like(cv0)
        y, st, cv = S.ssm_forward(cfg, mp, h, chunk=c, return_state=True,
                                  initial_state=st0, conv_state=cv0)
        ssm[slot:slot + 1] = st.to(ssm.dtype)
        conv[slot:slot + 1] = cv.to(conv.dtype)
        return y

    if cfg.is_ssm_only:
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            x = x + chunk_mix(lp["ssm"], rms_norm(x, lp["ln1"]["scale"]), cache["ssm"][i],
                              cache["conv"][i])
    elif cfg.is_hybrid:
        for p in range(_hybrid_counts(cfg)[0]):
            kc, vc, ssm, conv = (cache[name][p] for name in ("k", "v", "ssm", "conv"))
            x = _period(cfg, layer_params(params["layers"], p), x,
                        lambda ap, h: A.chunk_attention(cfg, ap, h, kc, vc, slot, offset)[0],
                        lambda mi, mp, h: chunk_mix(mp, h, ssm[mi], conv[mi]))
    else:
        for i in range(cfg.n_layers):
            kc, vc = cache["k"][i], cache["v"][i]
            x = _block(cfg, layer_params(params["layers"], i), x,
                       lambda ap, h: A.chunk_attention(cfg, ap, h, kc, vc, slot, offset)[0])
    return _head_out(cfg, params, x[:, -1:])[:, -1], dict(cache, pos=pos)


def decode_step(cfg, params: dict, cache: dict, tokens_or_embeds: torch.Tensor):
    """One decode step for the whole batch: tokens (B, 1) ->
    (logits (B, V), cache), the cache's K/V written in place and ``pos``
    advanced by one; the SSM family's and the hybrid's ``ssm`` and ``conv``
    are new tensors and the old ones are left as they were."""
    require_ported(cfg)
    x = _embed_in(cfg, params, tokens_or_embeds)
    pos = cache["pos"]
    if cfg.is_ssm_only:
        new_ssm, new_conv = torch.empty_like(cache["ssm"]), torch.empty_like(cache["conv"])
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            y, new_ssm[i], new_conv[i] = S.ssm_decode_step(
                cfg, lp["ssm"], rms_norm(x, lp["ln1"]["scale"]), cache["ssm"][i],
                cache["conv"][i])
            x = x + y
        return (_head_out(cfg, params, x)[:, -1],
                dict(cache, ssm=new_ssm, conv=new_conv, pos=pos + 1))
    if cfg.is_hybrid:
        new_ssm, new_conv = torch.empty_like(cache["ssm"]), torch.empty_like(cache["conv"])
        for p in range(_hybrid_counts(cfg)[0]):
            kc, vc = cache["k"][p], cache["v"][p]

            def mix(mi, mp, h, p=p):
                y, new_ssm[p, mi], new_conv[p, mi] = S.ssm_decode_step(
                    cfg, mp, h, cache["ssm"][p, mi], cache["conv"][p, mi])
                return y

            x = _period(cfg, layer_params(params["layers"], p), x,
                        lambda ap, h: A.decode_attention(cfg, ap, h, kc, vc, pos)[0], mix)
        return (_head_out(cfg, params, x)[:, -1],
                dict(cache, ssm=new_ssm, conv=new_conv, pos=pos + 1))
    for i in range(cfg.n_layers):
        kc, vc = cache["k"][i], cache["v"][i]
        x = _block(cfg, layer_params(params["layers"], i), x,
                   lambda ap, h: A.decode_attention(cfg, ap, h, kc, vc, pos)[0])
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
    decode step fits); the SSM family's cache (and the hybrid's, beside its
    K/V) holds each mixer's final state and conv tail, whatever
    ``max_len``."""
    require_ported(cfg)
    x = _embed_in(cfg, params, tokens_or_embeds)
    bsz, s = x.shape[0], x.shape[1]
    if cfg.is_ssm_only:
        sts, cvs = [], []
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            y, st, cv = S.ssm_forward(cfg, lp["ssm"], rms_norm(x, lp["ln1"]["scale"]),
                                      return_state=True)
            x = x + y
            sts.append(st)
            cvs.append(cv)
        cache = {"ssm": torch.stack(sts), "conv": torch.stack(cvs),
                 "pos": torch.full((bsz,), s, dtype=torch.int32, device=x.device)}
        return _head_out(cfg, params, x)[:, -1], cache
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    s_kv = A.cache_length(cfg, max_len if max_len is not None else s + 1)
    ks, vs = [], []

    def attend(p, h):
        y, k, v = A.attention_with_cache_write(cfg, p, h, positions)
        ks.append(_to_cache_layout(cfg, k.to(cfg.activation_dtype), s, s_kv))
        vs.append(_to_cache_layout(cfg, v.to(cfg.activation_dtype), s, s_kv))
        return y

    if cfg.is_hybrid:
        n_per, n_mix = _hybrid_counts(cfg)[:2]
        sts, cvs = [], []

        def mix(mi, mp, h):
            y, st, cv = S.ssm_forward(cfg, mp, h, return_state=True)
            sts.append(st)
            cvs.append(cv)
            return y

        for p in range(n_per):
            x = _period(cfg, layer_params(params["layers"], p), x, attend, mix)
    else:
        for i in range(cfg.n_layers):
            x = _block(cfg, layer_params(params["layers"], i), x, attend)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.full((bsz,), s, dtype=torch.int32, device=x.device)}
    if cfg.is_hybrid:
        cache["ssm"] = torch.stack(sts).unflatten(0, (n_per, n_mix))
        cache["conv"] = torch.stack(cvs).unflatten(0, (n_per, n_mix))
    return _head_out(cfg, params, x)[:, -1], cache
