"""The K-replica ensemble and the SSM family on the port's mesh
(``stoch.place_replicas``, ``ServeEngine(mesh=, plan=)``) on the CPU, in one
process with no process group, against the reference's functions and its
single-device output.

* The replica specs (``prepend_replica_axis``, ``replica_specs``) equal the
  reference's as entry tuples on the same stochastic plans; the
  reference's mesh functions read only ``mesh.axis_names`` and
  ``mesh.devices.shape``, so they get a stand-in grid.
* The ensemble mirrors the reference's replica-axis acceptance row
  (``tests/test_distributed.py``, StarCoder2 SMOKE, K = 4, "data" on a (4,)
  mesh and "model" on a (2, 2) mesh): the mesh streams equal the port's
  single-device ensemble and the reference's single-device ensemble. The
  reference's own forced-mesh run is not the oracle: it needs a forced JAX
  device count in a subprocess.
* mamba2's SMOKE config in det, stoch and xnor on (2, 2) and (1, 4) meshes:
  streams, whole-prompt and chunked with the prefix cache, equal the
  single-device engine's and the reference's batch-1 ``generate``. Torch's
  CPU GEMM blocks by N and M, so the mesh's cache rows and logits may part
  from one device's in the last bits (``STATE_TOL``); the depthwise conv's
  channel shards give the unsharded taps bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.configs import base as jcb
from repro.core.policy import DEFAULT_POLICY as J_POLICY
from repro.engine import compile_plan as j_compile_plan
from repro.models import transformer as JT
from repro.serve.batcher import SlotBatcher as JSlotBatcher
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import stream_serve as j_stream_serve
from repro.stoch import ensemble as j_ensemble
from repro.stoch import sample_replicas as j_sample_replicas
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.distributed import sharding as SH
from repro_torch.engine import compile_plan
from repro_torch.interop import from_jax_tree
from repro_torch.models import ssm as S
from repro_torch.obs.collectives import predict_call_collectives, predict_row_collective
from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve
from repro_torch.serve.engine import MeshCache, ReplicaMeshCache
from repro_torch.stoch import (place_replicas, prepend_replica_axis, replica_specs,
                               replica_view, sample_replicas)

ENS_ARCH, SSM_ARCH = "starcoder2_3b", "mamba2_130m"
K = 4
PROMPT_LEN = 8
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "d4": ((4,), ("data",))}
# the mesh's ssm/conv cache rows against one device's: torch's CPU f32 GEMM
# blocks by N and M, so the projections' outputs may differ in the last bits
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
_CACHE = {}


class StandIn:
    """What the reference's mesh functions read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _mesh(name):
    return SH.Mesh(*MESHES[name], device="cpu")


def _masters(arch):
    """(reference cfg, reference masters, port cfg, the masters carried)."""
    if arch not in _CACHE:
        jcfg = jcb.get_config(arch, smoke=True)
        jp = JT.init_lm(jcfg, jax.random.key(0))
        _CACHE[arch] = (jcfg, jp, cb.get_config(arch, smoke=True), from_jax_tree(jp, device="cpu"))
    return _CACHE[arch]


def _replicas(rax, k=K):
    """(reference ReplicaSet, port ReplicaSet) of the ensemble arch, the
    stochastic plans compiled with ``replica_axis=rax`` and no mesh, K
    replicas at key 1 on both sides."""
    key = ("rs", rax, k)
    if key not in _CACHE:
        _, jp, _, mp = _masters(ENS_ARCH)
        jplan = j_compile_plan(jp, J_POLICY, "stoch", warn=False, replica_axis=rax)
        plan = compile_plan(mp, DEFAULT_POLICY, "stoch", warn=False, replica_axis=rax)
        _CACHE[key] = (j_sample_replicas(jp, jplan, jax.random.key(1), k),
                       sample_replicas(mp, plan, prng.key(1), k))
    return _CACHE[key]


def _requests(vocab, max_news, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, PROMPT_LEN).astype(np.int32), m) for m in max_news]


def _serve(engine, reqs, n_slots=2, **kw):
    b = SlotBatcher(n_slots, PROMPT_LEN)
    for p, m in reqs:
        b.submit(p, m)
    stream_serve(engine, b, **kw)
    return {r.uid: list(map(int, r.generated)) for r in b.completed}


def _j_serve(jeng, reqs, n_slots=2):
    b = JSlotBatcher(n_slots, PROMPT_LEN)
    for p, m in reqs:
        b.submit(p, m)
    j_stream_serve(jeng, b)
    return {int(r.uid): list(map(int, r.generated)) for r in b.completed}


# ---------------------------------------------------------------------------
# the replica specs against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rax", ["data", "model", None])
@pytest.mark.parametrize("spec", [(None, "model"), ("data", None), ("model", "data"),
                                  (("pod", "data"), "model"), ((), None), ()])
def test_prepend_replica_axis_equals_the_reference(rax, spec):
    """The replica axis leads, and wins a clash with an inner entry (a
    tuple entry keeps its other names; an emptied one replicates)."""
    want = tuple(j_ensemble.prepend_replica_axis(rax, spec))
    assert prepend_replica_axis(rax, spec) == want
    assert want[0] == rax


def _j_specs(jspecs, path):
    node = jspecs[path]
    return {"packed": tuple(node.packed), "scale": tuple(node.scale)}


@pytest.mark.parametrize("rax,k,mesh", [("data", 4, None), ("model", 4, None), (None, 4, None),
                                        ("data", 4, "2x2"), ("model", 4, "2x2"),
                                        ("data", 3, "2x2"), ("model", 2, "1x4")])
def test_replica_specs_equal_the_reference(rax, k, mesh):
    """Every stacked array's spec, unsanitized and sanitized against a mesh:
    the lead (K) dim carries the axis, and a K the axis does not divide
    replicates the stack (K = 3 over "data" 2, K = 2 over "model" 4)."""
    jrs, rs = _replicas(rax, k)
    port_mesh = None if mesh is None else _mesh(mesh)
    stand_in = None if mesh is None else StandIn(*MESHES[mesh])
    got, want = replica_specs(rs, mesh=port_mesh), j_ensemble.replica_specs(jrs, mesh=stand_in)
    assert set(got) == set(want) == set(rs.paths)
    for path in rs.paths:
        assert got[path] == _j_specs(want, path), path
        lead = got[path]["packed"][0]
        sizes = {} if port_mesh is None else port_mesh.axis_sizes()
        assert lead == (None if rax is None or k % sizes.get(rax, 1) else rax)


# ---------------------------------------------------------------------------
# the ensemble on a mesh
# ---------------------------------------------------------------------------

def _ens_engines(rax, mesh_name, k=K):
    """(reference single-device ensemble, port single-device ensemble, port
    mesh ensemble) over the same replicas; the mesh engine's plan is
    compiled with the mesh, the replicas sampled with it."""
    jcfg, jp, cfg, mp = _masters(ENS_ARCH)
    jrs, rs = _replicas(rax, k)
    mesh = _mesh(mesh_name)
    plan = compile_plan(mp, DEFAULT_POLICY, "stoch", warn=False, mesh=mesh, replica_axis=rax)
    rs_m = sample_replicas(mp, plan, prng.key(1), k)
    return (JServeEngine(jcfg, None, ensemble=jrs), ServeEngine(cfg, None, ensemble=rs),
            ServeEngine(cfg, None, ensemble=rs_m, mesh=mesh, plan=plan))


@pytest.mark.parametrize("rax,mesh,k", [("data", "d4", 4), ("model", "2x2", 4),
                                        ("data", "2x2", 4), ("data", "2x2", 3)])
def test_ensemble_replica_axis_streams_equal_one_device_and_the_reference(rax, mesh, k):
    """The reference's acceptance row as the port's: K = 4 replicas split
    over "data" on a (4,) mesh and over "model" on a (2, 2) mesh (and
    "data" on the (2, 2) mesh, the replicas' inner dims on "model") stream
    greedy tokens equal to the single-device ensemble engine's and the
    reference's; the stacked words carry the replica axis on dim 0. K = 3
    does not divide "data" 2: the stack replicates, group 0 runs it."""
    jeng, single, eng = _ens_engines(rax, mesh, k)
    reqs = _requests(single.cfg.vocab_size, (3, 5, 2))
    got = _serve(eng, reqs)
    assert got == _serve(single, reqs) == _j_serve(jeng, reqs)
    w = eng._replicas.stacked["layers/attn/w_qkv"]
    split = k % eng.mesh.axis_sizes()[rax] == 0
    assert w.spec[0] == (rax if split else None)
    assert w.local.flat[0].packed.shape[0] == (k // eng.mesh.axis_sizes()[rax] if split else k)


@pytest.mark.parametrize("rax,mesh", [("data", "2x2"), ("model", "2x2"), (None, "2x2"),
                                      ("data", "1x4")])
def test_ensemble_logits_cache_and_collectives_on_the_mesh(rax, mesh):
    """``init_decode`` / ``prefill_into`` / ``decode_step`` on 4 slots: the
    mean logits, agreement and variance equal the single-device
    ensemble's (logits within ``STATE_TOL``: the CPU GEMM's blocking), the
    (K, ...) cache reads back equal, each (replica, slot shard) cache part
    sits where ``replica_view`` runs it, and a step's collectives follow
    the placement: under "data" (or None) each replica's call runs every
    row's collective, under "model" only the shared (base) rows'."""
    _, single, eng = _ens_engines(rax, mesh)
    prompts = [p for p, _ in _requests(single.cfg.vocab_size, (1,) * 4, seed=2)]
    states = []
    for e in (single, eng):
        st = e.init_decode(4, PROMPT_LEN, 3)
        for slot, p in enumerate(prompts):
            st = e.prefill_into(st, slot, p)
        states.append(e.decode_step(st, [3, 1, 4, 1]))
    a, b = states
    assert isinstance(b.cache, ReplicaMeshCache)
    torch.testing.assert_close(b.logits, a.logits, **STATE_TOL)
    assert torch.equal(b.agreement, a.agreement)
    torch.testing.assert_close(b.variance, a.variance, **STATE_TOL)
    for name in a.cache:
        torch.testing.assert_close(b.cache[name], a.cache[name], **STATE_TOL)

    sizes = eng.mesh.axis_sizes()
    groups = eng.mesh.shape[0]
    plan = eng._replicas.plan
    shared = {"all-gather": 0, "all-reduce": 0}      # the base rows' collectives a call
    for row in plan.compute_rows():
        c = predict_row_collective(row.sharding, row.shape, axis_sizes=sizes)
        if c is not None and row.path not in eng._replicas.paths:
            shared[c["kind"]] += 1
    per_call = (shared if rax == "model"
                else predict_call_collectives(plan, sizes, groups=1))
    calls = K * (1 if rax == "data" else groups)
    SH.reset_collective_counts()
    eng.decode_step(b, [0, 0, 0, 0])
    assert SH.collective_counts() == {kind: calls * n for kind, n in per_call.items()}


def test_ensemble_views_run_on_the_holder():
    """Under "model" replica r's stacked leaves sit whole on model position
    r // 2 of every group, and its call runs there; under "data" group g
    holds replicas 2g and 2g + 1, split over "model", and runs them on its
    lead position; ``place_replicas`` keeps the base leaves on the plan's
    column."""
    _, rs = _replicas("model")
    mesh = _mesh("2x2")
    placed = place_replicas(mesh, rs)
    for g in range(2):
        for r in range(K):
            pos, tree = replica_view(placed, r, g)
            assert pos == mesh.groups()[g][r // 2]
            w = tree["layers"]["attn"]["w_qkv"]
            assert torch.equal(w.packed, rs.stacked["layers/attn/w_qkv"].packed[r])
            assert isinstance(tree["embed"]["embedding"], SH.ModelShards)
    _, rs = _replicas("data")
    placed = place_replicas(mesh, rs)
    for g in range(2):
        for r in range(K):
            got = replica_view(placed, r, g)
            if r // 2 != g:
                assert got is None
                continue
            pos, tree = got
            assert pos == mesh.groups()[g][0]
            w = tree["layers"]["attn"]["w_qkv"]
            assert isinstance(w, SH.ModelShards) and len(w.parts) == 2
            assert torch.equal(torch.cat([p.packed for p in w.parts], -1),
                               rs.stacked["layers/attn/w_qkv"].packed[r])


# ---------------------------------------------------------------------------
# the SSM family on a mesh
# ---------------------------------------------------------------------------

SSM_MAX_NEWS = (4, 2, 5, 3)


def _ssm(mode, mesh_name):
    """(reference engine, port single-device engine, port mesh engine, its
    plan), one masters draw packed by each side at key 3."""
    key = ("ssm", mode)
    if key not in _CACHE:
        jcfg, jp, cfg, mp = _masters(SSM_ARCH)
        jtree = j_compile_plan(jp, J_POLICY, mode, warn=False).pack(jp, key=jax.random.key(3))
        _CACHE[key] = JServeEngine(jcfg, jtree)
    jeng = _CACHE[key]
    _, _, cfg, mp = _masters(SSM_ARCH)
    mesh = _mesh(mesh_name)
    plan = compile_plan(mp, DEFAULT_POLICY, mode, warn=False, mesh=mesh)
    tree = plan.pack(mp, key=prng.key(3))
    return jeng, ServeEngine(cfg, tree), ServeEngine(cfg, tree, mesh=mesh, plan=plan), plan


def _ssm_requests(cfg):
    reqs = _requests(cfg.vocab_size, SSM_MAX_NEWS, seed=4)
    reqs[3][0][:5] = reqs[0][0][:5]       # a shared 5-token prefix: a prefix-cache hit
    return reqs


def _j_generate(mode, jeng, reqs):
    """The reference's batch-1 ``generate`` of every request, cached."""
    key = ("ssm_gen", mode)
    if key not in _CACHE:
        _CACHE[key] = {i: np.asarray(jeng.generate(jnp.asarray(p)[None], m).tokens)[0].tolist()
                       for i, (p, m) in enumerate(reqs)}
    return _CACHE[key]


@pytest.mark.parametrize("mode", ["det", "stoch", "xnor"])
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_ssm_streams_equal_one_device_and_the_reference(mesh, mode):
    """mamba2 SMOKE on each mesh, 2 slots through a mid-stream refill:
    whole-prompt streams and chunked ones (chunks of 3, the prefix cache,
    a prefix hit) equal the single-device engine's and the reference's
    batch-1 ``generate``; the in_proj words split over "model" on N, the
    conv on its channels."""
    jeng, single, eng, _ = _ssm(mode, mesh)
    reqs = _ssm_requests(single.cfg)
    want = _j_generate(mode, jeng, reqs)
    assert _serve(eng, reqs) == _serve(single, reqs) == want
    pc = PrefixCache()
    assert _serve(eng, reqs, prefill_chunk=3, prefix_cache=pc) == want
    assert pc.hits >= 1
    n_model = eng.mesh.model_size
    ssm = eng.params["layers"]["ssm"]
    assert ssm["in_proj"].local.flat[0].packed.shape[-1] * n_model == ssm["in_proj"].master_shape[-1]
    assert ssm["conv"].spec == (None, None, "model")
    assert ssm["conv"].local.flat[0].shape[-1] * n_model == ssm["conv"].shape[-1]
    assert ssm["A_log"].spec == (None, None)


@pytest.mark.parametrize("mode", ["det", "xnor"])
def test_ssm_mesh_cache_rows_and_collectives(mode):
    """The (2, 2) mesh's ``MeshCache``: after ``prefill_into`` on 4 slots
    and after a decode step, its ``ssm`` and ``conv`` rows equal the
    single-device cache's within ``STATE_TOL``, each group's part holding
    its 2 slots; ``decode_step`` puts each group's new states back into its
    part. A call's collectives are the plan's prediction (in_proj, the
    conv, out_proj a layer, the embedding once) and one all-gather more a
    group: the tied head's vocab-parallel product, on the embedding row the
    predictor counts once."""
    _, single, eng, plan = _ssm(mode, "2x2")
    prompts = [p for p, _ in _requests(single.cfg.vocab_size, (1,) * 4, seed=5)]
    states = []
    for e in (single, eng):
        st = e.init_decode(4, PROMPT_LEN, 3)
        for slot, p in enumerate(prompts):
            st = e.prefill_into(st, slot, p)
        states.append(st)
    a, b = states
    assert isinstance(b.cache, MeshCache) and len(b.cache.parts) == 2
    assert b.cache.parts[1]["ssm"].shape[1] == 2
    for name in ("ssm", "conv", "pos"):
        torch.testing.assert_close(b.cache[name], a.cache[name], **STATE_TOL)
    old = [p["ssm"] for p in b.cache.parts]
    SH.reset_collective_counts()
    a, b = single.decode_step(a, [1, 2, 3, 4]), eng.decode_step(b, [1, 2, 3, 4])
    want = predict_call_collectives(plan, eng.mesh.axis_sizes(), groups=2)
    assert SH.collective_counts() == dict(want, **{"all-gather": want["all-gather"] + 2})
    for name in ("ssm", "conv", "pos"):
        torch.testing.assert_close(b.cache[name], a.cache[name], **STATE_TOL)
    assert all(p["ssm"] is not o for p, o in zip(b.cache.parts, old))
    torch.testing.assert_close(b.logits.float(), a.logits.float(), **STATE_TOL)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("history", [False, True])
def test_conv_shards_give_the_unsharded_taps_bit_for_bit(n_model, history):
    """``_causal_conv`` on a (W, C) conv split over "model" on C: each
    position's taps over its channel range, gathered, equal the unsharded
    call bit for bit, with and without a decode window."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 288, generator=g)
    xbc = torch.randn(3, 5, 288, generator=g)
    hist = torch.randn(3, 3, 288, generator=g) if history else None
    shards = SH.ModelShards(list(torch.chunk(w, n_model, dim=-1)), -1)
    before = SH.all_gather.count
    assert torch.equal(S._causal_conv(xbc, shards, history=hist),
                       S._causal_conv(xbc, w, history=hist))
    assert SH.all_gather.count == before + 1
