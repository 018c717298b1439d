"""Serving engine: packed-weight LM inference with prefill and batched
decode, single device (the reference's ``repro/serve/engine.py``).

Which datapath each projection gets is decided by the execution plan
(``repro_torch.engine``: ``compile_plan(...).pack``), and the model
dispatches through ``apply_linear`` on the serving leaves the plan
produced (K2 for ``packed``, K3 + K4 for ``xnor``).

Serving is step-level continuously batched (:func:`stream_serve`): the KV
cache (the SSM family's recurrent state and conv window) is a persistent
slot-addressed structure (:class:`DecodeState`), a
finished request's slot is re-prefilled from the queue mid-stream
(``ServeEngine.prefill_into``, or chunk by chunk with ``prefill_chunk_into``
and the fused decode + prefill step ``fused_step``), and one decode step
advances every slot. A prefix cache (``serve.prefix_cache``) splices the
snapshot of a prompt prefix already prefilled into a slot
(``capture_slot`` / ``splice_into``). Tokens are greedy or sampled at a
temperature with the threefry twin's ``categorical``. Where the reference
jits a fixed-shape program, the port runs eager PyTorch: every entry point
keeps the reference's shapes, and the cache is written in place where the
reference donates it.

A K-replica stochastic ensemble (``ServeEngine(ensemble=ReplicaSet)``)
decodes from the replicas' mean logits over a (K, ...) cache: where the
reference vmaps over the replicas, the port loops over them, each replica's
forward on its own view of the one cache.

On a device mesh (``ServeEngine(cfg, params, mesh=Mesh(...), plan=plan)``;
the dense and SSM families, and the ensemble) the engine places the tree
as the plan's sharding column says (``distributed.sharding.
place_packed_params``: packed words split over "model" on N, an xnor
row-parallel projection on whole words, a mixer's conv on its channels)
and the decode cache as ``T.cache_pspecs`` says: the slots split over the
data groups (:class:`MeshCache`). Every entry point runs each data group's
model call on its own slots with the group's shards, running the
model-axis collectives itself (``distributed.sharding``); the groups'
logits rows come back to the lead position, so ``stream_serve``, sampling
and the prefix cache stay one host loop. An ensemble's stacked leaves
carry the plan's ``replica_axis`` on their lead dim
(``stoch.place_replicas``), and so does its cache
(:class:`ReplicaMeshCache`): each (replica, slot shard) runs on the
position holding that replica, and the K replicas' logits come back to the
lead position in replica order before ``ensemble_stats``. The retrace
sentinel waits for ROADMAP item 8.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.distributed import sharding as SH
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import record_request_metrics
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.stoch import (ReplicaSet, ensemble_stats, place_replicas,
                               prepend_replica_axis, replica_view)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


def packed_param_bytes(params) -> tuple[int, int]:
    """(dense bf16 bytes, served bytes): a serving leaf counts its master
    shape, stack dims included, on the dense side (never its word count,
    which includes pad words) and its words and scale on the served side;
    every other leaf counts its bf16 size on both sides."""
    dense = packed = 0
    for _, leaf in tree_leaves_with_path(params):
        if hasattr(leaf, "master_shape"):
            dense += math.prod(leaf.master_shape) * 2
            packed += leaf.nbytes()
        else:
            dense += leaf.numel() * 2
            packed += leaf.numel() * 2
    return dense, packed


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GenerationResult:
    """Logprob convention: ``logprobs[b, i]`` is the log-probability of
    ``tokens[b, i]`` under the distribution the token was drawn from:
    ``softmax(logits / temperature)`` when sampling, ``softmax(logits)``
    for greedy decoding (temperature 0).

    The ensemble fields are set only when the engine serves a K >= 2
    ``ReplicaSet`` (None otherwise): ``vote_agreement[b, i]`` is the share
    of replicas whose argmax at step i matched the ensemble vote,
    ``logit_variance[b, i]`` the mean across-replica logit variance, and
    ``abstained[b]`` flags generations whose worst-step agreement fell
    below the engine's ``abstain_threshold``."""

    tokens: torch.Tensor       # (B, max_new) int32
    logprobs: torch.Tensor     # (B, max_new) f32
    steps: int
    logit_variance: Optional[torch.Tensor] = None   # (B, max_new) f32
    vote_agreement: Optional[torch.Tensor] = None   # (B, max_new) f32
    abstained: Optional[torch.Tensor] = None        # (B,) bool


@dataclasses.dataclass
class DecodeState:
    """Live state of the continuous-batching engine: one long-lived,
    slot-addressed KV cache plus the next-token logits of every slot.
    Requests come and go (``prefill_into``); the shapes never change."""

    cache: dict                # slot-addressed decode cache (B = n_slots);
                               # ensemble serving adds a leading (K,) axis
    logits: torch.Tensor       # (n_slots, vocab) next-token logits per slot
    n_slots: int
    prompt_len: int
    max_new_cap: int           # per-request max_new must be <= this
    # Ensemble serving's uncertainty of each slot's current logits (None on
    # the single-sample path): replica vote agreement and mean logit
    # variance, refreshed by every prefill_into / decode_step.
    agreement: Optional[torch.Tensor] = None     # (n_slots,) f32
    variance: Optional[torch.Tensor] = None      # (n_slots,) f32

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.max_new_cap


def tempered(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``logits`` in f32 divided by ``temperature``, a true division on
    every device (CUDA turns a division by a host scalar into a multiply by
    its reciprocal, which can round differently)."""
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    return logits.to(torch.float32) / t


def draw_tokens(logits: torch.Tensor, temperature: float = 0.0, key=None) -> torch.Tensor:
    """One emission step's int32 tokens over (B, V) ``logits``: the argmax,
    or with ``temperature > 0`` ``categorical(key, logits / temperature)``."""
    if temperature > 0.0:
        return prng.categorical(key, tempered(logits, temperature))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0, key=None):
    """:func:`draw_tokens` and the tokens' f32 log-probabilities under the
    distribution they were drawn from, as the reference's ``generate``."""
    tok = draw_tokens(logits, temperature, key)
    sample_logits = (tempered(logits, temperature) if temperature > 0.0
                     else logits.to(torch.float32))
    lp = torch.log_softmax(sample_logits, dim=-1)
    return tok, lp.gather(-1, tok[:, None].long())[:, 0]


@dataclasses.dataclass
class MeshCache:
    """A decode cache placed on a mesh: the slots split over the data
    groups (``T.cache_pspecs``), ``parts[g]`` a cache dict of group g's
    ``per`` slots on its lead position (one part, all slots, when the slots
    do not divide over the groups: the cache then replicates over the data
    axis and group 0 serves it). ``cache[name]`` reads an entry of every
    slot, concatenated on the first part's device."""

    parts: list
    per: int
    axes: dict                 # entry -> slot axis (T.cache_slot_axes)

    def locate(self, slot: int) -> tuple[int, int]:
        """(group, the slot's index within the group's part)."""
        return divmod(slot, self.per)

    def __getitem__(self, name: str) -> torch.Tensor:
        dev = self.parts[0][name].device
        return torch.cat([p[name].to(dev) for p in self.parts], dim=self.axes[name])

    def with_parts(self, parts: list) -> "MeshCache":
        return dataclasses.replace(self, parts=parts)


@dataclasses.dataclass
class ReplicaMeshCache:
    """The (K, ...) decode cache of a K-replica ensemble placed on a mesh as
    ``prepend_replica_axis(plan.replica_axis, T.cache_pspecs(...))`` says:
    ``parts[(r, s)]`` is the cache dict of replica r's slot shard s (``per``
    slots; one shard of every slot where the slots do not split, as under
    ``replica_axis="data"``), on the position that runs that replica for
    those slots. ``cache[name]`` reads an entry of every replica and slot,
    (K, ...) stacked, on the first part's device."""

    parts: dict
    per: int
    k: int
    axes: dict                 # entry -> slot axis (T.cache_slot_axes)

    def locate(self, slot: int) -> tuple[int, int]:
        """(slot shard, the slot's index within it)."""
        return divmod(slot, self.per)

    def __getitem__(self, name: str) -> torch.Tensor:
        dev = self.parts[(0, 0)][name].device
        shards = len(self.parts) // self.k
        return torch.stack([torch.cat([self.parts[(r, s)][name].to(dev) for s in range(shards)],
                                      dim=self.axes[name]) for r in range(self.k)])

    def with_parts(self, parts: dict) -> "ReplicaMeshCache":
        return dataclasses.replace(self, parts=parts)


def _replica_cache(cache: dict, r: int) -> dict:
    """Replica ``r``'s view of a (K, ...) ensemble cache: writes through the
    views land in the stacked tensors."""
    return {name: t[r] for name, t in cache.items()}


class ServeEngine:
    """Batched prefill + greedy or temperature decode over a (possibly
    packed) parameter tree, on the device its tensors live on.

    * one-shot: ``generate(prompts, max_new)``: prefill a batch, decode
      every row for ``max_new`` steps;
    * continuous batching: ``init_decode`` builds a persistent
      slot-addressed :class:`DecodeState`, ``prefill_into`` splices a fresh
      request into it at a slot, and ``decode_step`` advances all slots one
      token. ``stream_serve`` drives the loop against a ``SlotBatcher``;
    * chunked prefill and prefix reuse: ``prefill_chunk_into`` (a chunk
      alone), ``fused_step`` (every decoding slot one token and one slot's
      prefill one chunk), ``capture_slot`` / ``splice_into``;
    * ensemble: ``ensemble=ReplicaSet`` (``stoch.sample_replicas``) with
      K >= 2 runs every replica over its own (K, ...) cache view and
      decodes from the f32 mean logits; K = 1 is the single-sample path on
      ``ensemble.base``, bit for bit. ``abstain_threshold`` flags
      generations whose worst-step vote agreement is below it.

    * mesh: ``mesh=`` (``distributed.sharding.Mesh``, axes among "pod",
      "data" and "model") places ``params`` by ``plan``'s sharding column
      (or the same rules re-derived without a plan) and splits the decode
      slots over the data groups; streams equal the single-device engine's
      where the arithmetic allows it (every K2 and K4 column sums in an
      order N and M do not change). The dense and SSM families, and a
      K-replica ensemble (``ensemble=``: its stacked leaves and cache split
      over the plan's ``replica_axis``, "data", "model" or None); an MoE or
      hybrid cfg on a mesh waits for ROADMAP item 7b (MoE routing across
      the data groups).

    ``tracer`` (``repro_torch.obs.Tracer``) wraps every entry point in a
    span with a ``dispatch`` child (the call returns with its kernels
    queued) and a ``device`` child (the tracer's fence waits for the card);
    the default ``NULL_TRACER`` makes every span site a no-op."""

    def __init__(self, cfg, params, *, mesh=None, plan=None, ensemble=None,
                 abstain_threshold: Optional[float] = None, tracer=None):
        T.require_ported(cfg)
        if plan is not None and mesh is None:
            raise ValueError("ServeEngine(plan=...) only places params on a mesh; pass "
                             "mesh= as well (or drop plan=)")
        self.cfg = cfg
        self.mesh = mesh
        self._views = None
        self.abstain_threshold = abstain_threshold
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._replicas = None
        self._trees = None
        if ensemble is not None:
            if not isinstance(ensemble, ReplicaSet):
                raise TypeError(f"ensemble= expects a repro_torch.stoch.ReplicaSet "
                                f"(sample_replicas(...)), got {type(ensemble).__name__}")
            if params is not None and params is not ensemble.base:
                raise ValueError("pass either params or ensemble=ReplicaSet, not both "
                                 "(the ensemble's base tree is the parameter tree)")
            params = ensemble.base
            if mesh is not None and plan is None:
                plan = ensemble.plan
            # K = 1 (or no stochastic rows) is the single-sample path on base
            if ensemble.k > 1 and ensemble.stacked:
                self._replicas = ensemble
                if mesh is None:
                    self._trees = [ensemble.merge_replica(r) for r in range(ensemble.k)]
        if mesh is not None:
            self._views = self._place(mesh, params, plan)
            params = self.params
        else:
            self.params = params
        self.device = (mesh.devices.flat[0] if mesh is not None
                       else params["embed"]["embedding"].device)

    def _place(self, mesh, params, plan) -> list:
        """Places ``params`` on ``mesh`` (``self.params``) and returns each
        data group's view of it. An ensemble's replicas are placed by
        ``stoch.place_replicas`` and each (replica, data group) that holds a
        copy gets its view and the device of the position that runs it."""
        cfg = self.cfg
        if cfg.n_experts or cfg.is_hybrid:
            raise NotImplementedError(
                f"{cfg.name}: serving the {cfg.family} family on a mesh waits for ROADMAP "
                f"item 7b (an MoE layer's capacity follows the tokens of a call, so each data "
                f"group routing its own slots would change it: MoE routing across the data "
                f"groups)")
        odd = set(mesh.axis_names) - {SH.MODEL, *SH.BATCH_AXES}
        if odd:
            raise ValueError(f"a serving mesh has axes among {SH.BATCH_AXES + (SH.MODEL,)}, "
                             f"got {mesh.axis_names}")
        self._group_devs = [mesh.devices.flat[row[0]] for row in mesh.groups()]
        if self._replicas is not None:
            self._replicas = place_replicas(mesh, self._replicas, plan)
            self.params = self._replicas.base
            self._ens_views = {}
            for g in range(len(self._group_devs)):
                for r in range(self._replicas.k):
                    got = replica_view(self._replicas, r, g)
                    if got is not None:
                        self._ens_views[(r, g)] = (mesh.devices.flat[got[0]], got[1])
            return []
        self.params = SH.place_packed_params(mesh, params, plan)
        return [SH.group_view(self.params, g) for g in range(len(self._group_devs))]

    def _split(self, n: int) -> int:
        """How many data groups ``n`` slots (or prompt rows) split over: the
        sanitized slot spec of ``T.cache_pspecs`` (1 when they do not
        divide)."""
        spec = SH.sanitize_spec(self.mesh, T.cache_pspecs(self.cfg, SH.batch_axes(self.mesh))
                                ["pos"], (n,))
        sizes = self.mesh.axis_sizes()
        return math.prod(sizes[a] for a in SH.entry_axes(spec[0])) if spec else 1

    # -- one model call, on one device or over a mesh's data groups ---------

    def _prefill(self, tokens: torch.Tensor, max_len: int):
        """(last-token logits (B, V), cache) of a batched prefill; on a mesh
        the rows split over the data groups."""
        if self.mesh is None:
            return T.prefill(self.cfg, self.params, tokens, max_len=max_len)
        per = tokens.shape[0] // self._split(tokens.shape[0])
        lgs, parts = [], []
        for g in range(tokens.shape[0] // per):
            lg, part = T.prefill(self.cfg, self._views[g],
                                 tokens[g * per:(g + 1) * per].to(self._group_devs[g]),
                                 max_len=max_len)
            lgs.append(lg.to(self.device))
            parts.append(part)
        return torch.cat(lgs), MeshCache(parts, per, T.cache_slot_axes(self.cfg))

    def _decode(self, cache, tokens: torch.Tensor):
        """One decode step of every slot: (logits (n_slots, V), cache)."""
        if self.mesh is None:
            return T.decode_step(self.cfg, self.params, cache, tokens)
        lgs, parts = [], []
        for g, part in enumerate(cache.parts):
            lg, new = T.decode_step(self.cfg, self._views[g], part,
                                    tokens[g * cache.per:(g + 1) * cache.per].to(
                                        self._group_devs[g]))
            lgs.append(lg.to(self.device))
            parts.append(new)
        return torch.cat(lgs), cache.with_parts(parts)

    def _prefill_chunk(self, cache, toks: torch.Tensor, slot: int, offset: int):
        if self.mesh is None:
            return T.prefill_chunk(self.cfg, self.params, cache, toks, slot, offset)
        g, local = cache.locate(slot)
        lg, new = T.prefill_chunk(self.cfg, self._views[g], cache.parts[g],
                                  toks.to(self._group_devs[g]), local, offset)
        parts = list(cache.parts)
        parts[g] = new
        return lg.to(self.device), cache.with_parts(parts)

    def _keep(self, old, new, keep: torch.Tensor):
        if self.mesh is None:
            return T.cache_keep(self.cfg, old, new, keep)
        return new.with_parts([
            T.cache_keep(self.cfg, o, n, keep[g * new.per:(g + 1) * new.per].to(
                self._group_devs[g]))
            for g, (o, n) in enumerate(zip(old.parts, new.parts))])

    def _insert(self, cache, one: dict, slot: int) -> None:
        """Writes batch-1 cache rows ``one`` into ``cache`` at ``slot``, in place."""
        if self.mesh is None:
            T.cache_insert(self.cfg, cache, one, slot)
            return
        g, local = cache.locate(slot)
        dev = self._group_devs[g]
        T.cache_insert(self.cfg, cache.parts[g], {k: v.to(dev) for k, v in one.items()},
                       local)

    def _extract(self, cache, slot: int) -> dict:
        if self.mesh is None:
            return T.cache_extract(self.cfg, cache, slot)
        g, local = cache.locate(slot)
        return T.cache_extract(self.cfg, cache.parts[g], local)

    def _tokens(self, tokens, shape) -> torch.Tensor:
        """``tokens`` (a tensor, array or list) as int32 on the engine's device."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens, np.int32))
        return tokens.to(self.device, torch.int32).reshape(shape)

    # -- the ensemble's counterparts of prefill / decode_step ---------------

    def _ens_units(self, n: int) -> tuple[int, dict]:
        """An ensemble call over ``n`` slots (or prompt rows) on the mesh:
        (slots a shard, {(replica, slot shard): (device, tree)}) in replica
        order. The shards are those of the cache's sanitized slot spec
        (``prepend_replica_axis`` takes the replica axis out of it, so
        under "data" every slot is one shard); each (replica, shard) runs
        in the first data group of that shard that holds the replica."""
        mesh, k = self.mesh, self._replicas.k
        spec = SH.sanitize_spec(mesh, prepend_replica_axis(
            self._replicas.plan.replica_axis,
            T.cache_pspecs(self.cfg, SH.batch_axes(mesh))["pos"]), (k, n))
        slot = spec[1]
        shards = math.prod(mesh.axis_sizes()[a] for a in SH.entry_axes(slot))
        rows = mesh.groups()
        units = {}
        for r in range(k):
            for s in range(shards):
                g = next(g for g, row in enumerate(rows)
                         if SH._shard_index(mesh, slot, row[0]) == s and (r, g) in self._ens_views)
                units[(r, s)] = self._ens_views[(r, g)]
        return n // shards, units

    def _ens_mesh_calls(self, fn, rows: torch.Tensor, parts: Optional[dict] = None):
        """``fn(tree, rows of the shard on its device, the shard's cache
        part or None)`` -> (logits, cache part) for every (replica, slot
        shard) of the mesh: (EnsembleStats of the (K, n, V) logits on the
        lead position, {(r, s): cache part}, slots a shard)."""
        per, units = self._ens_units(rows.shape[0])
        lgs = [[] for _ in range(self._replicas.k)]
        out = {}
        for (r, s), (dev, tree) in units.items():
            lg, out[(r, s)] = fn(tree, rows[s * per:(s + 1) * per].to(dev),
                                 None if parts is None else parts[(r, s)])
            lgs[r].append(lg.to(self.device))
        return ensemble_stats(torch.stack([torch.cat(lg) for lg in lgs])), out, per

    def _ens_prefill(self, prompts: torch.Tensor, max_len: int):
        """Every replica's prefill: (EnsembleStats, (K, ...) cache)."""
        if self.mesh is not None:
            es, parts, per = self._ens_mesh_calls(
                lambda tree, toks, _: T.prefill(self.cfg, tree, toks, max_len=max_len), prompts)
            return es, ReplicaMeshCache(parts, per, self._replicas.k,
                                        T.cache_slot_axes(self.cfg))
        lgs, caches = [], []
        for tree in self._trees:
            lg, cache = T.prefill(self.cfg, tree, prompts, max_len=max_len)
            lgs.append(lg)
            caches.append(cache)
        cache = {name: torch.stack([c[name] for c in caches]) for name in caches[0]}
        return ensemble_stats(torch.stack(lgs)), cache

    def _ens_decode(self, cache: dict, tokens: torch.Tensor):
        """One decode step of every replica on its view of the (K, ...)
        cache (K/V written in place; the entries a decode step returns
        anew, ``T.STEP_STATE``, stacked; on a mesh each part's own):
        (EnsembleStats, cache)."""
        if self.mesh is not None:
            es, parts, _ = self._ens_mesh_calls(
                lambda tree, toks, part: T.decode_step(self.cfg, tree, part, toks), tokens,
                cache.parts)
            return es, cache.with_parts(parts)
        lgs, news = [], []
        for r, tree in enumerate(self._trees):
            lg, new = T.decode_step(self.cfg, tree, _replica_cache(cache, r), tokens)
            lgs.append(lg)
            news.append(new)
        anew = {name: torch.stack([n[name] for n in news])
                for name in T.STEP_STATE if name in cache}
        return ensemble_stats(torch.stack(lgs)), dict(cache, **anew)

    # -- one-shot generation ----------------------------------------------

    @torch.inference_mode()
    def generate(self, prompts, max_new: int, temperature: float = 0.0,
                 key: Optional[prng.Key] = None) -> GenerationResult:
        """``max_new`` tokens for each row of ``prompts`` (B, S): greedy, or
        sampled at ``temperature`` with ``key`` (``core.prng.key(...)``),
        split once a token as the reference splits it."""
        if temperature > 0.0 and key is None:
            raise ValueError("temperature-sampled generation requires a PRNG key: pass "
                             "key=prng.key(...) to generate(), or use temperature=0.0 "
                             "for greedy decoding")
        prompts = self._tokens(prompts, (len(prompts), -1))
        if self._replicas is not None:
            return self._generate_ensemble(prompts, max_new, temperature, key)
        logits, cache = self._prefill(prompts, prompts.shape[1] + max_new)
        toks, lps = [], []
        for i in range(max_new):
            sub = None
            if temperature > 0.0:
                key, sub = prng.split(key)
            tok, lp = sample_tokens(logits, temperature, sub)
            toks.append(tok)
            lps.append(lp)
            if i < max_new - 1:
                logits, cache = self._decode(cache, tok[:, None])
        return GenerationResult(torch.stack(toks, 1), torch.stack(lps, 1), max_new)

    def _generate_ensemble(self, prompts, max_new, temperature, key) -> GenerationResult:
        """One-shot generation over all K replicas: tokens come from the
        ensemble-mean logits, and every step records vote agreement and
        logit variance."""
        es, cache = self._ens_prefill(prompts, prompts.shape[1] + max_new)
        toks, lps, agrs, vrs = [], [], [], []
        for i in range(max_new):
            sub = None
            if temperature > 0.0:
                key, sub = prng.split(key)
            tok, lp = sample_tokens(es.mean_logits, temperature, sub)
            toks.append(tok)
            lps.append(lp)
            agrs.append(es.agreement)
            vrs.append(es.variance)
            if i < max_new - 1:
                es, cache = self._ens_decode(cache, tok[:, None])
        agreement = torch.stack(agrs, 1)
        abstained = None
        if self.abstain_threshold is not None:
            abstained = agreement.amin(dim=1) < self.abstain_threshold
        return GenerationResult(torch.stack(toks, 1), torch.stack(lps, 1), max_new,
                                logit_variance=torch.stack(vrs, 1),
                                vote_agreement=agreement, abstained=abstained)

    # -- step-level continuous batching -----------------------------------

    @torch.inference_mode()
    def init_decode(self, n_slots: int, prompt_len: int, max_new_cap: int) -> DecodeState:
        """A zeroed slot-addressed cache for ``prompt_len + max_new_cap``
        positions and an empty next-token logits buffer; slots fill with
        ``prefill_into``, and empty slots decode padding. An ensemble gets
        one cache a replica on a leading (K,) axis, f32 logits, and the
        uncertainty columns at their no-signal values (agreement 1,
        variance 0). On a mesh the cache is placed: a :class:`MeshCache` of
        the slots split over the data groups, each part on its group's lead
        position (an ensemble's a :class:`ReplicaMeshCache`); the logits
        stay on the lead position."""
        ctx = prompt_len + max_new_cap
        ens = self._replicas
        if self.mesh is None:
            cache = T.init_cache(self.cfg, n_slots, ctx, device=self.device)
            if ens is not None:
                cache = {k: torch.zeros((ens.k,) + tuple(v.shape), dtype=v.dtype,
                                        device=v.device) for k, v in cache.items()}
        elif ens is None:
            per = n_slots // self._split(n_slots)
            cache = MeshCache([T.init_cache(self.cfg, per, ctx, device=self._group_devs[g])
                               for g in range(n_slots // per)], per,
                              T.cache_slot_axes(self.cfg))
        else:
            per, units = self._ens_units(n_slots)
            cache = ReplicaMeshCache({u: T.init_cache(self.cfg, per, ctx, device=dev)
                                      for u, (dev, _) in units.items()}, per, ens.k,
                                     T.cache_slot_axes(self.cfg))
        agreement = variance = None
        if ens is not None:
            agreement = torch.ones((n_slots,), dtype=torch.float32, device=self.device)
            variance = torch.zeros((n_slots,), dtype=torch.float32, device=self.device)
        logits = torch.zeros((n_slots, self.cfg.vocab_size),
                             dtype=torch.float32 if ens is not None
                             else self.cfg.activation_dtype, device=self.device)
        return DecodeState(cache, logits, n_slots, prompt_len, max_new_cap,
                           agreement=agreement, variance=variance)

    @torch.inference_mode()
    def prefill_into(self, state: DecodeState, slot: int, prompt) -> DecodeState:
        """Prefills one request (a prompt of ``prompt_len`` tokens) and
        writes its cache rows and first-token logits into ``state`` at
        ``slot``, in place. Returns the state."""
        tr = self.tracer
        prompt = self._tokens(prompt, (1, state.prompt_len))
        with tr.span("prefill_into", slot=slot):
            with tr.span("dispatch"):
                if self._replicas is None and self.mesh is not None:
                    g, local = state.cache.locate(slot)     # the slot's data group
                    lg, one = T.prefill(self.cfg, self._views[g],
                                        prompt.to(self._group_devs[g]),
                                        max_len=state.context_len)
                    state.logits[slot] = lg[0].to(self.device, state.logits.dtype)
                    T.cache_insert(self.cfg, state.cache.parts[g], one, local)
                elif self._replicas is None:
                    lg, one = T.prefill(self.cfg, self.params, prompt,
                                        max_len=state.context_len)
                    state.logits[slot] = lg[0].to(state.logits.dtype)
                    T.cache_insert(self.cfg, state.cache, one, slot)
                else:
                    lgs = []
                    for r in range(self._replicas.k):
                        if self.mesh is None:
                            tree, dev, part, local = (self._trees[r], self.device,
                                                      _replica_cache(state.cache, r), slot)
                        else:       # the position holding replica r for the slot's shard
                            s_, local = state.cache.locate(slot)
                            dev, tree = self._ens_units(state.n_slots)[1][(r, s_)]
                            part = state.cache.parts[(r, s_)]
                        lg, one = T.prefill(self.cfg, tree, prompt.to(dev),
                                            max_len=state.context_len)
                        T.cache_insert(self.cfg, part, one, local)
                        lgs.append(lg.to(self.device))
                    es = ensemble_stats(torch.stack(lgs))       # mean (1, V); stats (1,)
                    state.logits[slot] = es.mean_logits[0]
                    state.agreement[slot] = es.agreement[0]
                    state.variance[slot] = es.variance[0]
            with tr.span("device"):
                tr.fence(state.logits)
        return state

    @torch.inference_mode()
    def decode_step(self, state: DecodeState, tokens) -> DecodeState:
        """Advances every slot one token. ``tokens`` (n_slots,): the token
        just emitted per slot; inactive slots feed padding and their outputs
        are ignored."""
        tr = self.tracer
        tokens = self._tokens(tokens, (state.n_slots, 1))
        with tr.span("decode_step"):
            with tr.span("dispatch"):
                if self._replicas is None:
                    logits, cache = self._decode(state.cache, tokens)
                    new = dataclasses.replace(state, cache=cache, logits=logits)
                else:
                    es, cache = self._ens_decode(state.cache, tokens)
                    new = dataclasses.replace(state, cache=cache, logits=es.mean_logits,
                                              agreement=es.agreement, variance=es.variance)
            with tr.span("device"):
                tr.fence(new.logits)
        return new

    @torch.inference_mode()
    def decode_steps(self, state: DecodeState, d: int):
        """Advances every slot ``d`` greedy tokens (argmax, decode, repeat)
        with no host read between them. Returns ``(new_state, tokens)``,
        ``tokens`` a (n_slots, d) int32 device tensor, so the serving loop
        reads the host once per ``d`` tokens. ``state.logits`` stays the
        not-yet-emitted next-token logits. Greedy and single-sample only."""
        if self._replicas is not None:
            raise NotImplementedError("decode_steps is single-sample only; ensemble serving "
                                      "decodes one step at a time (stream_serve falls back)")
        tr = self.tracer
        cache, logits, toks = state.cache, state.logits, []
        with tr.span("decode_steps", d=d):
            with tr.span("dispatch"):
                for _ in range(d):
                    tok = torch.argmax(logits, dim=-1).to(torch.int32)
                    lg, cache = self._decode(cache, tok[:, None])
                    logits = lg.to(logits.dtype)
                    toks.append(tok)
            with tr.span("device"):
                tr.fence(logits)
        return dataclasses.replace(state, cache=cache, logits=logits), torch.stack(toks, 1)

    # -- chunked prefill + prefix reuse ------------------------------------

    def _require_single_sample(self, what: str) -> None:
        if self._replicas is not None:
            raise NotImplementedError(
                f"{what} is single-sample only; K-replica ensemble serving prefills whole "
                f"prompts (stream_serve falls back)")

    @torch.inference_mode()
    def prefill_chunk_into(self, state: DecodeState, slot: int, tokens,
                           offset: int) -> DecodeState:
        """Advances one slot's prefill by a chunk of prompt tokens, no
        decode (the ramp-up and drain path of chunked prefill). ``offset``
        is the number of prompt tokens already in the slot."""
        self._require_single_sample("prefill_chunk_into")
        tr = self.tracer
        toks = self._tokens(tokens, (1, -1))
        with tr.span("prefill_chunk", slot=slot, offset=int(offset), c=int(toks.shape[1])):
            with tr.span("dispatch"):
                lg, cache = self._prefill_chunk(state.cache, toks, slot, int(offset))
                state.logits[slot] = lg[0].to(state.logits.dtype)
            with tr.span("device"):
                tr.fence(state.logits)
        return dataclasses.replace(state, cache=cache)

    @torch.inference_mode()
    def fused_step(self, state: DecodeState, tokens, keep_mask, slot: int, chunk_tokens,
                   offset: int) -> DecodeState:
        """The chunked-prefill steady state: every live decode slot one token
        and one slot's prefill one chunk, in one call. ``tokens``: (n_slots,)
        just-emitted tokens; ``keep_mask``: (n_slots,) bool, True for
        mid-prefill slots whose logits and position must survive the batched
        decode.

        The decode writes K/V in place for every slot, mid-prefill ones
        included, at index ``pos[slot]`` (the chunk's offset, pinned by the
        previous chunk): that is the row the chunk overwrites after its
        attention, which masks it. ``decode_step`` returns a new ``pos``
        and leaves the old one unmodified, so ``cache_keep`` re-selects the
        old counters of the kept slots before the chunk sets its own."""
        self._require_single_sample("fused_step")
        tr = self.tracer
        tokens = self._tokens(tokens, (state.n_slots, 1))
        keep = torch.as_tensor(np.asarray(keep_mask, bool)).to(self.device)
        toks = self._tokens(chunk_tokens, (1, -1))
        with tr.span("decode_prefill", slot=slot, offset=int(offset), c=int(toks.shape[1])):
            with tr.span("dispatch"):
                dec_lg, dec_cache = self._decode(state.cache, tokens)
                cache = self._keep(state.cache, dec_cache, keep)
                logits = torch.where(keep[:, None], state.logits,
                                     dec_lg.to(state.logits.dtype))
                lg, cache = self._prefill_chunk(cache, toks, slot, int(offset))
                logits[slot] = lg[0].to(logits.dtype)
            with tr.span("device"):
                tr.fence(logits)
        return dataclasses.replace(state, cache=cache, logits=logits)

    @torch.inference_mode()
    def capture_slot(self, state: DecodeState, slot: int):
        """Host snapshot of one slot's cache rows and logits row (CPU
        tensors), the capture side of the prefix cache: one device-to-host
        copy, at a chunk boundary."""
        self._require_single_sample("capture_slot")
        with self.tracer.span("prefix_capture", slot=slot):
            one = self._extract(state.cache, slot)
            lg = state.logits[slot:slot + 1]
            return {k: v.cpu() for k, v in one.items()}, lg.cpu()

    @torch.inference_mode()
    def splice_into(self, state: DecodeState, slot: int, cache_rows: dict,
                    logits_row=None) -> DecodeState:
        """Splices a prefix-cache snapshot into a slot, in place (a prefix
        hit). With ``logits_row`` (a full-prompt snapshot) the slot can
        decode at once; otherwise chunked prefill goes on from the
        snapshot's offset."""
        self._require_single_sample("splice_into")
        tr = self.tracer
        use_lg = logits_row is not None
        with tr.span("prefix_splice", slot=slot, full=bool(use_lg)):
            with tr.span("dispatch"):
                one = {k: torch.as_tensor(v).to(self.device) for k, v in cache_rows.items()}
                self._insert(state.cache, one, slot)
                if use_lg:
                    state.logits[slot] = torch.as_tensor(logits_row).reshape(-1).to(
                        self.device, state.logits.dtype)
            with tr.span("device"):
                tr.fence(state.logits)
        return state


def stream_serve(engine: ServeEngine, batcher, *, max_new_cap: Optional[int] = None,
                 temperature: float = 0.0, key: Optional[prng.Key] = None, metrics=None,
                 decode_chunk: int = 1, sentinel=None, prefill_chunk: int = 0,
                 prefix_cache=None, arrivals=None) -> int:
    """Step-level continuous-batching serving loop.

    Each iteration retires finished requests and re-prefills their slots
    from the queue (``batcher.refill``), emits one token for every active
    slot from the state's next-token logits, then runs one decode step over
    all slots. A request finishing mid-stream frees its slot for the next
    queued request on the next step, and per-request ``max_new`` is honoured
    exactly. ``max_new_cap`` sizes the persistent cache (default: the
    largest ``max_new`` queued). Returns the number of token-emission steps
    (the model runs ``steps - 1`` decode steps plus one prefill a request).

    ``temperature > 0`` samples every emission step with
    ``categorical(sub, logits / temperature)``, splitting ``key`` once a
    step as the reference does. ``decode_chunk > 1`` (greedy,
    single-sample) runs ``d = min(decode_chunk, shortest live request's
    remaining budget)`` decode steps a call (``ServeEngine.decode_steps``)
    and reads the host once per ``d`` tokens; slot turnover stays on the
    chunk boundary, so every stream is the one-token loop's.

    ``prefill_chunk > 0`` (single-sample) admits prompts ``prefill_chunk``
    tokens at a time: each iteration fuses one chunk of the oldest
    mid-prefill slot into the decode step (``fused_step``) when any slot is
    decoding, else runs the chunk alone (``prefill_chunk_into``).
    Mid-prefill slots are flagged on the batcher (``mark_prefilling``), so
    no decode output lands in their ledger and ``t_first`` stamps on the
    first generated token. Ring (sliding-window) caches clamp the chunk to
    the cache length. ``prefix_cache`` (a ``serve.PrefixCache``) snapshots
    the slot at every chunk boundary under the prompt prefix's hash, and an
    arriving prompt whose prefix is cached splices the snapshot in
    (``splice_into``) and skips those chunks; a full-prompt hit skips
    prefill altogether. It implies chunked prefill (the chunk defaults to
    ``prompt_len``).

    ``arrivals`` (callable ``iteration -> bool``) injects open-loop
    arrivals: called once an iteration (submitting to the batcher as it
    sees fit), it returns True while more requests may come, and the loop
    then idles through empty iterations instead of returning.

    Observability: the engine's tracer wraps the loop in a ``stream_serve``
    span with one ``step`` span an iteration (``refill`` / ``sample`` /
    ``record`` children; the engine adds ``prefill_into`` /
    ``decode_step`` / ``prefill_chunk`` / ``decode_prefill`` /
    ``prefix_splice`` with their dispatch/device split, and
    ``prefix_capture``). ``metrics`` (a ``repro_torch.obs.MetricsRegistry``)
    records per-step latency, queue depth and slot occupancy,
    prefill/chunk/step/token counters, the ledger's TTFT/latency (and
    ensemble agreement) histograms, the ``serve_prefix_*`` counters and
    bytes gauge, and a ``serve_tok_per_s`` gauge.

    ``sentinel`` (the retrace sentinel) waits for ROADMAP queue 1 item 8."""
    if sentinel is not None:
        raise _not_ported("the retrace sentinel (stream_serve(sentinel=...))",
                          "ROADMAP queue 1 item 8")
    if temperature > 0.0 and key is None:
        raise ValueError("temperature-sampled serving requires a PRNG key")
    cap = max_new_cap
    if cap is None:
        pending = [r.max_new for r in batcher.queue]
        if not pending:
            return 0
        cap = max(pending)
    tr = engine.tracer
    step_h = queue_h = occ_h = None
    if metrics is not None:
        step_h = metrics.histogram("serve_step_seconds", "wall seconds per serving-loop step")
        queue_h = metrics.histogram("serve_queue_depth", "queued requests, sampled per step")
        occ_h = metrics.histogram("serve_slot_occupancy",
                                  "active-slot fraction, sampled per step")
    use_prefill_chunks = prefill_chunk > 0 or prefix_cache is not None
    if use_prefill_chunks and engine._replicas is not None:
        raise NotImplementedError("chunked prefill / prefix reuse is single-sample only; drop "
                                  "prefill_chunk=/prefix_cache= for K-replica ensemble serving")
    chunk_len = prefill_chunk if prefill_chunk > 0 else batcher.prompt_len
    if use_prefill_chunks and engine.cfg.sliding_window:
        # ring caches need chunk <= cache length: chunk_attention's
        # post-attention ring write gives each chunk token its own row
        chunk_len = min(chunk_len, A.cache_length(engine.cfg, batcher.prompt_len + cap))
    if prefix_cache is not None:
        # salt keys with the serving geometry (and this engine's identity):
        # snapshots of another engine, context geometry or chunking must
        # never splice in, since chunked and whole prefills agree only to
        # ulp order
        prefix_cache.bind_geometry(
            f"{id(engine)}:{engine.cfg.family}:{engine.cfg.vocab_size}:"
            f"{batcher.prompt_len}:{cap}:{chunk_len}")
    pc_start = prefix_cache.stats() if prefix_cache is not None else None
    in_prefill: dict[int, int] = {}   # slot -> prompt tokens already in

    def advance_prefill(state, slot, new_off):
        """Bookkeeping after a chunk landed: snapshot the chunk boundary
        into the prefix cache, and promote the slot to the decoding set
        once its whole prompt is in."""
        req = batcher.slots[slot]
        full = new_off >= batcher.prompt_len
        if prefix_cache is not None and (prefix_cache.store_partial or full):
            one, lg = engine.capture_slot(state, slot)
            prefix_cache.put(req.prompt[:new_off], one, logits=lg if full else None)
        if full:
            batcher.mark_ready(slot)
            del in_prefill[slot]
        else:
            in_prefill[slot] = new_off

    def sample(state):
        """One emission step's tokens (device) and their host copy."""
        nonlocal key
        with tr.span("sample"):
            sub = None
            if temperature > 0.0:
                key, sub = prng.split(key)
            tok = draw_tokens(state.logits, temperature, sub)
            return tok, tok.cpu().numpy()

    t_start = time.perf_counter()
    steps = 0
    iterations = 0
    use_chunks = decode_chunk > 1 and temperature == 0.0 and engine._replicas is None
    with tr.span("stream_serve", n_slots=batcher.n_slots, cap=cap):
        with tr.span("init_decode"):
            state = engine.init_decode(batcher.n_slots, batcher.prompt_len, cap)
        try:
            while True:
                t_step = time.perf_counter()
                iterations += 1
                more_arrivals = bool(arrivals(iterations)) if arrivals is not None else False
                with tr.span("step", step=steps):
                    with tr.span("refill"):
                        for slot in batcher.refill():
                            req = batcher.slots[slot]
                            if req.max_new > cap:
                                raise ValueError(
                                    f"request {req.uid} wants max_new={req.max_new} but "
                                    f"the decode state was sized for max_new_cap={cap}")
                            if metrics is not None:
                                metrics.counter("serve_prefills_total",
                                                "slot prefills (one per request "
                                                "admitted)").inc()
                            if not use_prefill_chunks:
                                state = engine.prefill_into(state, slot, req.prompt)
                                continue
                            off = 0
                            if prefix_cache is not None:
                                hit = prefix_cache.lookup(req.prompt, chunk_len)
                                if hit is not None:
                                    off, entry = hit
                                    full = off >= batcher.prompt_len
                                    state = engine.splice_into(
                                        state, slot, entry.cache,
                                        logits_row=entry.logits if full else None)
                            if off < batcher.prompt_len:
                                batcher.mark_prefilling(slot)
                                in_prefill[slot] = off
                    if metrics is not None:
                        queue_h.observe(len(batcher.queue))
                        occ_h.observe(float(np.mean(batcher.active_mask())))
                    if batcher.idle:
                        if more_arrivals:
                            continue
                        return steps
                    if use_prefill_chunks and in_prefill:
                        # fuse one chunk of the oldest mid-prefill slot into
                        # the decode step when anything is decoding, else
                        # run the chunk alone
                        slot = next(iter(in_prefill))
                        off = in_prefill[slot]
                        req = batcher.slots[slot]
                        c = min(chunk_len, batcher.prompt_len - off)
                        chunk_toks = req.prompt[off:off + c]
                        if batcher.active_mask().any():
                            tok, tok_host = sample(state)
                            with tr.span("record"):
                                batcher.record(tok_host)
                            steps += 1
                            if metrics is not None:
                                metrics.counter("serve_steps_total",
                                                "token-emission steps").inc()
                            keep = np.array([i in batcher.prefilling
                                             for i in range(batcher.n_slots)])
                            state = engine.fused_step(state, tok, keep, slot, chunk_toks, off)
                        else:
                            state = engine.prefill_chunk_into(state, slot, chunk_toks, off)
                        advance_prefill(state, slot, off + c)
                        if metrics is not None:
                            metrics.counter("serve_prefill_chunks_total",
                                            "prefill chunks executed").inc()
                        if step_h is not None:
                            step_h.observe(time.perf_counter() - t_step)
                        continue
                    if use_chunks:
                        d = min(decode_chunk, batcher.min_remaining())
                        with tr.span("chunk", d=d):
                            state, toks = engine.decode_steps(state, d)
                            tok_chunk = toks.cpu().numpy()       # the chunk's one host read
                        with tr.span("record"):
                            for i in range(d):
                                batcher.record(tok_chunk[:, i])
                        steps += d
                        if metrics is not None:
                            metrics.counter("serve_steps_total",
                                            "token-emission steps").inc(d)
                        if batcher.idle:
                            batcher.refill()
                        if step_h is not None:
                            step_h.observe(time.perf_counter() - t_step)
                        if batcher.idle and not more_arrivals:
                            return steps
                        continue
                    tok, tok_host = sample(state)
                    with tr.span("record"):
                        if state.agreement is not None:
                            agr = state.agreement.cpu().numpy()
                            thr = engine.abstain_threshold
                            batcher.record(tok_host, agreement=agr,
                                           variance=state.variance.cpu().numpy(),
                                           abstained=None if thr is None else agr < thr)
                        else:
                            batcher.record(tok_host)
                    steps += 1
                    if metrics is not None:
                        metrics.counter("serve_steps_total", "token-emission steps").inc()
                    if batcher.idle:
                        # flush the final completions; a trailing decode
                        # step would be pure waste
                        batcher.refill()
                        if step_h is not None:
                            step_h.observe(time.perf_counter() - t_step)
                        if not more_arrivals:
                            return steps
                        continue
                    state = engine.decode_step(state, tok)
                if step_h is not None:
                    step_h.observe(time.perf_counter() - t_step)
        finally:
            if metrics is not None:
                record_request_metrics(metrics, batcher)
                if prefix_cache is not None:
                    pc = prefix_cache.stats()
                    metrics.counter("serve_prefix_hits_total",
                                    "prefix-cache hits (prefill chunks skipped)").inc(
                        pc["hits"] - pc_start["hits"])
                    metrics.counter("serve_prefix_misses_total",
                                    "prefix-cache misses (cold prefills)").inc(
                        pc["misses"] - pc_start["misses"])
                    metrics.counter("serve_prefix_evictions_total",
                                    "prefix-cache LRU evictions").inc(
                        pc["evictions"] - pc_start["evictions"])
                    metrics.counter("serve_prefix_tokens_skipped_total",
                                    "prompt tokens served from cached prefixes").inc(
                        pc["tokens_skipped"] - pc_start["tokens_skipped"])
                    metrics.gauge("serve_prefix_bytes",
                                  "prefix-cache resident bytes").set(pc["bytes"])
                dt = time.perf_counter() - t_start
                if dt > 0:
                    metrics.gauge("serve_tok_per_s",
                                  "recorded tokens / serving wall seconds").set(
                        batcher.tokens_generated / dt)
