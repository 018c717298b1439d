"""Serving driver: fixed-batch inference of the paper's nets (the MNIST FC
net and VGG-16 on CIFAR-10), and step-level continuous-batching serving of
the dense, MoE, SSM and hybrid LM families, with binary weights, and in
``xnor`` mode binary activations too (not for MoE experts, which the
reference serves in ``det`` and ``stoch`` only).

The master weights are compiled into an execution plan (``repro_torch.engine``)
and packed with K1. Per batch, ``det``/``stoch`` run the hidden projections
on K2 (packed weights) and VGG's binarized convs densely (``packed_conv``
unpacks its words first); ``xnor`` runs the hidden projections on K3 + K4
and VGG's conv blocks 2-5 on K5 + K4. The input and classifier layers stay
dense. Prints the weight bytes before and after packing, ms/batch and img/s.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mnist_fc \
      --binarize det --slots 4 --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16_cifar10 \
      --binarize xnor --slots 4 --requests 64

Token archs (``serve_lm``; the dense family: starcoder2_3b, qwen2_5_32b,
h2o_danube_3_4b, deepseek_coder_33b; the MoE family: moonshot_v1_16b_a3b,
grok_1_314b, whose expert projections run on the expert-batched K2; the
SSM family: mamba2_130m, whose Mamba2 mixers run ``in_proj`` and
``out_proj`` on K2, or K3 + K4 in ``xnor``; the hybrid: jamba_1_5_large,
Mamba2 and attention 1:7 with MoE on alternate layers, whose packed masters
are drawn and packed a matrix at a time) stream requests through
``serve.engine.stream_serve``: a persistent slot-addressed KV cache,
per-step slot refill (the SSM family's recurrent state and conv window
in place of K/V), per-request ``max_new``, tok/s from tokens actually
recorded. ``--packed`` serves the plan's packed leaves (every attention,
MLP and expert projection: K2, or K3 + K4 in ``xnor``); without it the
dense masters. ``--binarize xnor`` on an arch with MoE layers (the MoE
family, jamba) exits naming the reference's gap
(``engine.backends.XNOR_EXPERTS_ABSENT``).
``--trace OUT.json`` writes a Chrome trace of the loop (dispatch vs device
spans; ``--no-trace-fence`` drops the device fence) and ``--metrics-out
OUT.json|.prom`` the serving metrics:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
      --packed --binarize xnor --requests 16 --slots 4 --prompt-len 32 \
      --max-new 16 --trace build/trace.json --metrics-out build/metrics.prom

``--prefill-chunk C`` admits prompts C tokens at a time through the fused
decode + prefill step, ``--prefix-cache N`` keeps an N-entry LRU of prompt
prefix snapshots (``--shared-prefix P`` gives every request the same first
P tokens, so they hit), and ``--ensemble K`` (``--packed --binarize
stoch``) serves K stochastic replicas from their mean logits, reporting
vote agreement (``--abstain-threshold A`` flags requests below A):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
      --packed --binarize det --prefill-chunk 8 --prefix-cache 32 \
      --shared-prefix 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
      --packed --binarize stoch --ensemble 4 --abstain-threshold 0.6

Plan manifests, as the reference's serve: ``--plan OUT.json`` saves the
compiled plan, ``--plan-from IN.json`` serves a saved one (its mode
supersedes ``--binarize``), ``--plan-report`` prints the per-layer
backend/bytes/reason table, ``--override PATH=BACKEND`` forces a layer
(path or '/'-prefix) onto a backend, and ``--analyze`` runs the plan lints
and exits 1 on an error finding (classifiers):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16_cifar10 \
      --binarize xnor --override conv/3=binarized_dense --plan-report

Stochastic ensemble of the classifiers: ``--ensemble K`` (with ``--binarize
stoch``) draws K packed replicas of every stochastic layer, classifies from
the ensemble-mean logits and reports the replicas' vote agreement;
``--abstain-threshold A`` counts the images whose agreement is below A:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mnist_fc \
      --binarize stoch --ensemble 8 --abstain-threshold 0.6

Token archs of the dense and SSM families also serve on a device mesh:
``--mesh data,model --mesh-shape 2,2`` places the packed tree by the plan's
sharding column (words split over "model") and the decode slots over
"data" (``ServeEngine(mesh=, plan=)``); the mesh's positions go round-robin
over the visible cards, so on one card all four share ``cuda:0``. A
K-replica ensemble (``--ensemble K``) splits its replicas over
``--replica-axis`` (data or model):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
      --smoke --device cpu --packed --binarize xnor --mesh data,model \
      --mesh-shape 2,2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_3b \
      --smoke --device cpu --packed --binarize stoch --ensemble 4 \
      --replica-axis model --mesh data,model --mesh-shape 2,2

Runs on the CUDA device unless ``--device cpu`` is given; asking for CUDA
where there is none raises. The collective audit and compiled-program
analysis of a token arch (ROADMAP item 8) are not ported: their flags exit
naming the item, and so do an MoE or hybrid arch on a mesh (item 7b: MoE
routing across the data groups).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Any

import torch

import numpy as np

from repro_torch.configs import base as cb
from repro_torch.configs import mnist_fc as C
from repro_torch.configs import vgg16_cifar10 as VC
from repro_torch.core import prng
from repro_torch.core.policy import DEFAULT_POLICY, make_paper_policy
from repro_torch.data import synthetic as syn
from repro_torch.distributed.sharding import Mesh, position_nbytes
from repro_torch.engine import ExecutionPlan, compile_plan, format_plan_table, plan_report
from repro_torch.engine.backends import XNOR_EXPERTS_ABSENT
from repro_torch.models import mnist_fc, vgg
from repro_torch.models import transformer as T
from repro_torch.obs import MetricsRegistry, Tracer, validate_trace
from repro_torch.serve import PrefixCache, SlotBatcher
from repro_torch.serve.engine import ServeEngine, packed_param_bytes, stream_serve
from repro_torch.stoch import ReplicaSet, ensemble_forward, sample_replicas

ARCHS = ("mnist_fc", "vgg16_cifar10")

# untimed batches before the clock starts: the first forward in a process pays
# for library initialisation and module loads, not for serving
WARMUP_BATCHES = 1


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch sees no CUDA "
                           f"device (pass device='cpu' to run on the CPU)")
    return dev


@dataclasses.dataclass
class ServeResult:
    requests: int
    seconds: float                  # wall time of the request loop
    batch_seconds: list[float]      # per batch, forward through argmax, synced
    warmup: int                     # untimed batches run before the clock starts
    dense_bytes: int
    packed_bytes: int
    params: Any                     # the packed serving tree
    state: Any
    last_x: torch.Tensor
    last_logits: torch.Tensor       # the ensemble-mean logits in an ensemble serve
    plan: ExecutionPlan
    replicas: ReplicaSet | None = None      # the ensemble's, K >= 2
    agreement: list[float] | None = None    # vote agreement of every request served
    abstained: int | None = None            # requests below the abstain threshold

    @property
    def mean_agreement(self) -> float | None:
        return None if self.agreement is None else statistics.fmean(self.agreement)

    @property
    def min_agreement(self) -> float | None:
        return None if self.agreement is None else min(self.agreement)

    @property
    def ms_per_batch(self) -> float:
        return statistics.median(self.batch_seconds) * 1e3

    @property
    def img_per_s(self) -> float:
        return self.requests / self.seconds


def build_model(arch: str, seed: int, *, device, smoke: bool = False):
    """(master tree, apply fn, data kind, number of FC layers) of ``arch``,
    with weights drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if arch == "mnist_fc":
        tree = mnist_fc.init(gen, hidden=C.SMOKE_HIDDEN if smoke else C.HIDDEN,
                             device=device)
        return tree, mnist_fc.apply, "mnist", len(tree["params"]["layers"])
    if arch == "vgg16_cifar10":
        tree = vgg.init(gen, width_mult=VC.SMOKE_WIDTH_MULT if smoke else VC.WIDTH_MULT,
                        device=device)
        return tree, vgg.apply, "cifar", len(tree["params"]["fc"])
    raise ValueError(f"arch must be one of {ARCHS}, not {arch!r}")


def make_serve_mesh(mesh: str, mesh_shape: str = "", *, device="cuda") -> Mesh | None:
    """The serving mesh of ``--mesh`` (axis names, e.g. ``data,model``) and
    ``--mesh-shape`` (sizes, e.g. ``2,2``; default: every visible card on
    the last axis, one position on the CPU), or None without ``--mesh``."""
    if not mesh:
        if mesh_shape:
            raise SystemExit("--mesh-shape requires --mesh (axis names)")
        return None
    axes = tuple(a.strip() for a in mesh.split(",") if a.strip())
    if mesh_shape:
        shape = tuple(int(n) for n in mesh_shape.split(","))
    else:
        cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
        shape = (1,) * (len(axes) - 1) + (max(cards, 1),)
    if len(shape) != len(axes):
        raise SystemExit(f"--mesh has {len(axes)} axes but --mesh-shape has {len(shape)} "
                         f"entries")
    m = Mesh(shape, axes, device=device)
    devs = sorted({str(d) for d in m.devices.flat})
    print(f"mesh: {m.axis_sizes()} over {m.size} positions on {', '.join(devs)}")
    return m


def mesh_axis_sizes(mesh) -> dict | None:
    """{axis: size} for plan_report's predicted-collective column."""
    return None if mesh is None else dict(zip(mesh.axis_names, mesh.devices.shape))


def parse_overrides(override) -> dict[str, str]:
    """``PATH=BACKEND`` strings -> {path: backend}, as the reference's CLI."""
    overrides = {}
    for kv in override:
        if "=" not in kv:
            raise SystemExit(f"--override expects PATH=BACKEND (e.g. "
                             f"conv/3=binarized_dense), got {kv!r}")
        path, backend = kv.split("=", 1)
        overrides[path] = backend
    return overrides


def make_plan(params, policy, *, binarize: str = "det", with_scale: bool = True,
              plan_out: str = "", plan_from: str = "", show_report: bool = False,
              report_batch: int = C.BATCH_SIZE, override=(), ensemble: int = 1,
              replica_axis: str = "data", mesh=None) -> ExecutionPlan:
    """Compiles (or loads) the execution plan and runs the requested plan
    I/O, as the reference's ``make_plan``. A loaded plan is authoritative:
    its mode decides the packing and the sign-activation forward, whatever
    ``binarize`` says. With a ``mesh`` the compiled sharding column is
    sanitized against it, and the report predicts its collectives at its
    axis sizes."""
    if plan_from:
        if override:
            raise SystemExit("--override edits a plan at compile time; it cannot be "
                             "combined with --plan-from")
        plan = ExecutionPlan.load(plan_from)
        if plan.mode != binarize:
            print(f"plan {plan_from} was compiled with mode={plan.mode}; serving that "
                  f"(--binarize {binarize} ignored)")
    else:
        plan = compile_plan(params, policy, binarize, with_scale=with_scale,
                            overrides=parse_overrides(override) or None, mesh=mesh,
                            replica_axis=replica_axis if ensemble > 1 else None)
    if ensemble > 1 and plan.replica_axis is None:
        # a v2 manifest, or one compiled without an ensemble: adopt the CLI's
        plan.replica_axis = replica_axis
    if plan_out:
        print(f"plan manifest -> {plan.save(plan_out)}")
    if show_report:
        print(format_plan_table(plan_report(plan, batch=report_batch,
                                            axis_sizes=mesh_axis_sizes(mesh))))
    return plan


def serve_classifier(*, arch: str = "mnist_fc", binarize: str = "det",
                     slots: int = C.BATCH_SIZE, requests: int = 64, seed: int = 0,
                     device="cuda", smoke: bool = False, with_scale: bool = True,
                     plan_out: str = "", plan_from: str = "", show_report: bool = False,
                     override=(), analyze: bool = False, ensemble: int = 1,
                     abstain_threshold: float | None = None,
                     replica_axis: str = "data", metrics_out: str = "") -> ServeResult:
    """Fixed-batch image-classification serving of the paper's nets.
    ``WARMUP_BATCHES`` untimed batches run first and are not counted as
    requests. The plan's mode decides the sign-activation forward.
    ``metrics_out`` writes the reference's classifier metrics there (JSON,
    or Prometheus text for a .prom/.txt path).

    ``ensemble`` K >= 2 serves K replicas drawn at ``prng.key(seed + 1)``
    (``stoch.sample_replicas``; needs a stochastic plan) and classifies
    from their mean logits; ``abstain_threshold`` counts the requests whose
    vote agreement is below it. ``analyze`` lints the plan and raises
    ``SystemExit(1)`` after serving if an error finding stands."""
    arch = arch.replace("-", "_")
    if slots < 1 or requests < 1:
        raise ValueError("slots and requests must be >= 1")
    if ensemble < 1:
        raise ValueError(f"ensemble size must be >= 1, got {ensemble}")
    if ensemble > 1 and not (binarize == "stoch" or plan_from):
        raise SystemExit("--ensemble K samples K stochastic replicas: add --binarize stoch")
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tree, apply_fn, kind, n_fc = build_model(arch, seed, device=dev, smoke=smoke)
    params, state = tree["params"], tree["state"]
    plan = make_plan(params, make_paper_policy(n_fc), binarize=binarize,
                     with_scale=with_scale, plan_out=plan_out, plan_from=plan_from,
                     show_report=show_report, report_batch=slots, override=override,
                     ensemble=ensemble, replica_axis=replica_axis)
    findings = plan.lint() if analyze else None
    replicas = None
    if ensemble > 1:
        if plan.mode != "stoch":
            raise SystemExit(f"--ensemble needs a stochastic plan, got mode={plan.mode} "
                             f"(--binarize stoch)")
        replicas = sample_replicas(params, plan, prng.key(seed + 1), ensemble)
        params = replicas.base
        dense_b, _ = packed_param_bytes(params)
        packed_b = replicas.tree_nbytes()
        print(f"ensemble K={ensemble} (stoch): {dense_b / 1e6:.1f}MB (bf16 dense, 1 copy) "
              f"-> {packed_b / 1e6:.1f}MB ({ensemble} packed replicas, shared leaves once)")
    else:
        params = plan.pack(params, key=prng.key(seed + 1))
        dense_b, packed_b = packed_param_bytes(params)
        print(f"packed weights ({plan.mode}): {dense_b / 1e6:.1f}MB (bf16 dense) -> "
              f"{packed_b / 1e6:.1f}MB ({dense_b / max(packed_b, 1):.1f}x smaller)")
    binary_act = plan.mode == "xnor"

    def forward(x):
        """(logits, per-image vote agreement or None)."""
        if replicas is None:
            return apply_fn(params, state, x, binary_act=binary_act), None
        es = ensemble_forward(replicas, lambda t: apply_fn(t, state, x,
                                                           binary_act=binary_act))
        return es.mean_logits, es.agreement

    spec = syn.SyntheticSpec(kind, batch_size=slots, seed=seed)
    agrees = []
    with torch.inference_mode():
        for _ in range(WARMUP_BATCHES):
            x, _ = syn.train_batch(spec, 0, device=dev)
            torch.argmax(forward(x)[0], dim=-1)
        sync()
        t0, done, lat = time.perf_counter(), 0, []
        for step in range(-(-requests // slots)):
            x, _ = syn.train_batch(spec, step, device=dev)
            t1 = time.perf_counter()
            logits, agr = forward(x)
            preds = torch.argmax(logits, dim=-1)
            sync()
            lat.append(time.perf_counter() - t1)
            take = min(slots, requests - done)
            if agr is not None:
                agrees.extend(agr[:take].tolist())
            done += take
    del preds
    abstained = None
    if agrees and abstain_threshold is not None:
        abstained = sum(a < abstain_threshold for a in agrees)
    res = ServeResult(requests=done, seconds=time.perf_counter() - t0,
                      batch_seconds=lat, warmup=WARMUP_BATCHES, dense_bytes=dense_b,
                      packed_bytes=packed_b, params=params, state=state, last_x=x,
                      last_logits=logits, plan=plan, replicas=replicas,
                      agreement=agrees or None, abstained=abstained)
    print(f"served {done} requests in {len(lat)} batches of {slots} on {dev}, "
          f"{res.seconds:.3f}s ({res.ms_per_batch:.3f} ms/batch median, "
          f"{res.img_per_s:.1f} img/s)")
    if agrees:
        msg = (f"ensemble uncertainty: mean vote agreement {res.mean_agreement:.3f} "
               f"(min {res.min_agreement:.3f})")
        if abstain_threshold is not None:
            msg += f"; abstained {abstained}/{done} at threshold {abstain_threshold}"
        print(msg)
    if metrics_out:
        metrics = MetricsRegistry()
        h = metrics.histogram("serve_batch_seconds", "wall seconds per inference batch")
        for sec in lat:
            h.observe(sec)
        metrics.counter("serve_images_total", "images classified").inc(done)
        metrics.gauge("serve_img_per_s", "images / serving wall seconds").set(res.img_per_s)
        if agrees:
            ah = metrics.histogram("serve_vote_agreement",
                                   "per-image ensemble replica vote agreement (0-1)")
            for a in agrees:
                ah.observe(float(a))
            if abstain_threshold is not None:
                metrics.counter("serve_abstain_total",
                                "images below the abstain threshold").inc(abstained)
        write_metrics(metrics, metrics_out)
    if findings is not None:
        from repro_torch.analysis import format_findings, gate

        print(format_findings(findings, title="static verifier (plan lints):"))
        if gate(findings):
            raise SystemExit(1)
    return res


def write_metrics(metrics: MetricsRegistry, path: str) -> None:
    """Prometheus text for a .prom/.txt path, else JSON, as the reference's CLI."""
    if path.endswith((".prom", ".txt")):
        with open(path, "w") as f:
            f.write(metrics.to_prometheus())
        print(f"metrics (prometheus) -> {path}")
    else:
        print(f"metrics -> {metrics.save(path)}")


@dataclasses.dataclass
class LMServeResult:
    cfg: Any
    steps: int                      # token-emission steps
    seconds: float                  # wall time of stream_serve, synced
    engine: ServeEngine             # its params: the served tree
    batcher: SlotBatcher            # the ledger: completed requests, prompts, tokens
    plan: ExecutionPlan | None
    dense_bytes: int
    packed_bytes: int
    # plan.pack (or sample_replicas), synced; None when not packed; a packed
    # hybrid's is plan.pack_drawn, so it includes drawing the masters
    pack_seconds: float | None
    tracer: Tracer | None
    metrics: MetricsRegistry | None
    prefix_cache: PrefixCache | None = None
    replicas: ReplicaSet | None = None      # the ensemble's, K >= 2

    @property
    def tokens(self) -> int:
        return self.batcher.tokens_generated

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.seconds

    @property
    def median_ttft(self) -> float:
        return statistics.median(r.ttft for r in self.batcher.completed)

    @property
    def median_latency(self) -> float:
        return statistics.median(r.latency for r in self.batcher.completed)


def serve_lm(*, arch: str = "starcoder2_3b", packed: bool = False, binarize: str = "det",
             requests: int = 16, slots: int = 4, prompt_len: int = 32, max_new: int = 16,
             max_new_skew: int = 0, seed: int = 0, device="cuda", smoke: bool = False,
             plan_out: str = "", plan_from: str = "", show_report: bool = False,
             override=(), trace: str = "", trace_fence: bool = True,
             metrics_out: str = "", prefill_chunk: int = 0, prefix_cache: int = 0,
             shared_prefix: int = 0, ensemble: int = 1,
             abstain_threshold: float | None = None, replica_axis: str = "data",
             n_layers: int | None = None, mesh: Mesh | None = None) -> LMServeResult:
    """Step-level continuous-batching serving of a token arch, as the
    reference's ``launch.serve`` token path: master weights drawn from
    ``seed`` (``torch.Generator``), packed at ``prng.key(seed + 1)`` when
    ``packed`` (the masters are dropped once packed), ``requests`` synthetic
    prompts of ``prompt_len`` tokens from ``numpy.random.default_rng(seed)``
    (the first ``shared_prefix`` tokens the same for all), each asking
    ``max_new`` tokens less up to ``max_new_skew``, served on ``slots``
    slots. ``prefill_chunk`` admits prompts that many tokens at a time;
    ``prefix_cache`` N > 0 adds an N-entry prefix cache. ``ensemble`` K >= 2
    (with a stochastic plan) serves K replicas drawn at ``prng.key(seed +
    1)`` (replica 0 is the single-sample pack), ``abstain_threshold``
    flagging requests whose vote agreement falls below it. ``trace`` writes
    a Chrome trace of the loop and validates it; ``metrics_out`` writes the
    serving metrics. ``n_layers`` cuts the config's depth, its widths kept
    (a card that cannot hold every layer's f32 masters; a hybrid's must be a
    multiple of its period).

    A packed hybrid (jamba) serve with one sample never holds its master
    tree: the plan is compiled from the masters' shapes
    (``T.lm_shapes``) and ``plan.pack_drawn`` draws each (K, N) matrix and
    packs it at once, which gives ``plan.pack(T.init_lm(...))`` bit for
    bit. Its ensemble, and every other family, draws the masters whole.

    ``mesh`` (``distributed.sharding.Mesh``; the dense and SSM families)
    serves the tree placed on it by the plan's sharding column, the decode
    slots split over its data groups (``ServeEngine(mesh=, plan=)``); an
    ensemble's replicas split over ``replica_axis`` (recorded in the
    plan)."""
    arch = cb.canonical_arch(arch)
    if (prefill_chunk or prefix_cache) and ensemble > 1:
        raise SystemExit("--prefill-chunk/--prefix-cache are single-sample serving features; "
                         "K-replica ensemble serving prefills whole prompts")
    cfg = cb.get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if cfg.frontend:
        raise SystemExit(f"{arch} uses a stubbed frontend; serve a token arch")
    if mesh is not None and (cfg.n_experts or cfg.is_hybrid):
        raise SystemExit(f"--mesh: serving the {cfg.family} family on a mesh waits for "
                         f"ROADMAP item 7b (MoE routing across the data groups)")
    if (plan_from or override) and not packed:
        raise SystemExit("--plan-from/--override change how weights are packed; add "
                         "--packed (use --plan/--plan-report alone for a dry inspection)")
    if ensemble > 1 and not (packed and binarize == "stoch" or plan_from):
        raise SystemExit("--ensemble K samples K stochastic replicas: add --packed "
                         "--binarize stoch")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # a single-sample packed hybrid draws and packs its masters a matrix at a
    # time, from a plan compiled from their shapes
    drawn = cfg.is_hybrid and packed and ensemble == 1
    params = T.lm_shapes(cfg) if drawn else T.init_lm(cfg, gen, device=dev)
    plan = None
    if packed or plan_out or plan_from or show_report or override:
        plan = make_plan(params, DEFAULT_POLICY, binarize=binarize, plan_out=plan_out,
                         plan_from=plan_from, show_report=show_report, report_batch=slots,
                         override=override, ensemble=ensemble, replica_axis=replica_axis,
                         mesh=mesh)
    pack_seconds = replicas = None
    if cfg.n_experts and packed and plan.mode == "xnor":
        raise SystemExit(f"{arch}: {XNOR_EXPERTS_ABSENT}")
    if packed:
        if ensemble > 1 and plan.mode != "stoch":
            raise SystemExit(f"--ensemble needs a stochastic plan, got mode={plan.mode} "
                             f"(--binarize stoch)")
        t0 = time.perf_counter()
        if ensemble > 1:
            # the key the single-sample pack uses, so replica 0 is --packed alone
            replicas = sample_replicas(params, plan, prng.key(seed + 1), ensemble)
            params = replicas.base
        elif drawn:
            params = plan.pack_drawn(T.lm_draws(cfg), gen, key=prng.key(seed + 1), device=dev)
        else:
            params = plan.pack(params, key=prng.key(seed + 1))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        pack_seconds = time.perf_counter() - t0
    elif plan is not None:
        print("(--packed not set: serving dense master weights; the compiled plan is "
              "not applied)")
    dense_b, packed_b = packed_param_bytes(params)
    if replicas is not None:
        packed_b = replicas.tree_nbytes()
        print(f"ensemble K={ensemble} (stoch): {dense_b / 1e6:.1f}MB (bf16 dense, 1 copy) "
              f"-> {packed_b / 1e6:.1f}MB ({ensemble} packed replicas, shared leaves once)")
    elif packed:
        print(f"packed weights: {dense_b / 1e6:.1f}MB (bf16 dense) -> {packed_b / 1e6:.1f}MB "
              f"({dense_b / max(packed_b, 1):.1f}x smaller)")
    tracer = Tracer(fence=trace_fence) if trace else None
    metrics = MetricsRegistry() if metrics_out else None
    engine = ServeEngine(cfg, None if replicas is not None else params, ensemble=replicas,
                         abstain_threshold=abstain_threshold, tracer=tracer, mesh=mesh,
                         plan=plan if packed and mesh is not None else None)
    if mesh is not None:
        del params          # the engine holds the placed tree
        per = position_nbytes(engine.params)
        if engine._replicas is not None:      # the replica stacks, beside the base
            per = per + sum(leaf.position_nbytes() for leaf in engine._replicas.stacked.values())
        print(f"placed on the mesh: {', '.join(f'{b / 1e6:.1f}' for b in per.flat)} MB "
              f"a position (row-major)")
    pc = PrefixCache(max_entries=prefix_cache) if prefix_cache else None
    batcher = SlotBatcher(slots, prompt_len, tracer=tracer)
    rng = np.random.default_rng(seed)
    shared = (rng.integers(0, cfg.vocab_size, min(shared_prefix, prompt_len))
              if shared_prefix else None)
    for _ in range(requests):
        # per-request max_new: uniform in [max(1, max_new - skew), max_new]
        m = max_new - int(rng.integers(0, max_new_skew + 1))
        prompt = rng.integers(0, cfg.vocab_size, prompt_len)
        if shared is not None:
            prompt[:shared.shape[0]] = shared
        batcher.submit(prompt, max(1, m))
    t0 = time.perf_counter()
    steps = stream_serve(engine, batcher, max_new_cap=max_new, metrics=metrics,
                         prefill_chunk=prefill_chunk, prefix_cache=pc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = LMServeResult(cfg=cfg, steps=steps, seconds=time.perf_counter() - t0,
                        engine=engine, batcher=batcher, plan=plan, dense_bytes=dense_b,
                        packed_bytes=packed_b, pack_seconds=pack_seconds, tracer=tracer,
                        metrics=metrics, prefix_cache=pc, replicas=replicas)
    done = batcher.completed
    # throughput from tokens actually recorded, never steps * batch
    ttft = res.median_ttft if done else float("nan")
    lat = res.median_latency if done else float("nan")
    print(f"served {len(done)} requests in {steps} decode steps, {res.seconds:.2f}s "
          f"({res.tokens} tokens, {res.tok_per_s:.1f} tok/s; median TTFT {ttft * 1e3:.1f} ms, "
          f"median latency {lat * 1e3:.1f} ms)")
    if pc is not None:
        st = pc.stats()
        print(f"prefix cache: {st['hits']} hits / {st['misses']} misses, "
              f"{st['tokens_skipped']} prompt tokens skipped, {st['entries']} entries "
              f"({st['bytes'] / 1e6:.1f}MB), {st['evictions']} evictions")
    if replicas is not None and done:
        alla = np.array([a for r in done for a in r.agreement])
        msg = (f"ensemble uncertainty: mean vote agreement {alla.mean():.3f} "
               f"(min {alla.min():.3f})")
        if abstain_threshold is not None:
            msg += (f"; abstained {sum(1 for r in done if r.abstained)}/{len(done)} "
                    f"requests at threshold {abstain_threshold}")
        print(msg)
    if metrics is not None:
        h = metrics["serve_step_seconds"].summary()
        if h.get("count"):
            print(f"step latency: p50 {h['p50'] * 1e3:.1f} ms, p95 {h['p95'] * 1e3:.1f} ms, "
                  f"p99 {h['p99'] * 1e3:.1f} ms over {h['count']} steps")
        write_metrics(metrics, metrics_out)
    if tracer is not None:
        path = tracer.save(trace)
        info = validate_trace(path)
        cov = "n/a" if info["coverage"] is None else f"{info['coverage'] * 100:.1f}%"
        print(f"trace -> {path} ({info['spans']} spans, step coverage {cov}; open in "
              f"https://ui.perfetto.dev)")
    return res


#: The reference's token-arch flags whose features are not ported yet, and
#: the ROADMAP item each waits for.
_DEFERRED_LM_FLAGS = (("audit_collectives", "--audit-collectives", "queue 1 item 8"),
                      ("analyze", "--analyze", "queue 1 item 8"))


def main(argv=None) -> ServeResult | LMServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mnist_fc",
                    help=f"{' | '.join(ARCHS)}, or a token arch: "
                         f"{' | '.join(a for a in cb.ARCH_IDS if a not in ARCHS)} "
                         f"(the dense, MoE, SSM and hybrid families run; MoE and hybrid "
                         f"in det and stoch)")
    ap.add_argument("--binarize", default="det", choices=["det", "stoch", "xnor"])
    ap.add_argument("--packed", action="store_true",
                    help="token archs: serve the plan's packed leaves (without it, the "
                         "dense masters); the classifiers always serve packed")
    ap.add_argument("--slots", type=int, default=C.BATCH_SIZE,
                    help="images per batch (the paper's batch is 4), or decode slots")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: 64 images, 16 token requests)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16,
                    help="per-request max_new cap (the decode cache is sized for "
                         "prompt_len + max_new positions)")
    ap.add_argument("--max-new-skew", type=int, default=0,
                    help="lower each request's max_new by a random 0..this many tokens "
                         "(exercises per-step slot refill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the plain versions")
    ap.add_argument("--smoke", action="store_true",
                    help=f"mnist_fc hidden widths {C.SMOKE_HIDDEN} instead of {C.HIDDEN}; "
                         f"vgg16_cifar10 width_mult {VC.SMOKE_WIDTH_MULT}; a token arch's "
                         f"SMOKE config")
    ap.add_argument("--plan", default="", metavar="OUT.json",
                    help="save the compiled execution-plan manifest to this path")
    ap.add_argument("--plan-from", default="", metavar="IN.json",
                    help="serve a saved plan manifest instead of compiling one (its "
                         "mode supersedes --binarize)")
    ap.add_argument("--plan-report", action="store_true",
                    help="print the per-layer backend/reason/bytes table")
    ap.add_argument("--override", action="append", default=[], metavar="PATH=BACKEND",
                    help="force a layer (path or '/'-prefix) onto a backend, e.g. "
                         "conv/3=binarized_dense (repeatable)")
    ap.add_argument("--analyze", action="store_true",
                    help="lint the plan (repro_torch.analysis); exit 1 on an error finding")
    ap.add_argument("--ensemble", type=int, default=1, metavar="K",
                    help="serve a K-replica stochastic ensemble (needs --binarize stoch, "
                         "and --packed on a token arch): classify or decode from the mean "
                         "logits, report vote agreement")
    ap.add_argument("--abstain-threshold", type=float, default=None,
                    help="count a request as abstained when its replica vote agreement "
                         "is below this (needs --ensemble >= 2)")
    ap.add_argument("--replica-axis", default="data", choices=["data", "model"],
                    help="mesh axis the ensemble replica dim shards over (recorded in "
                         "the plan manifest, v3)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="token archs: write a Chrome trace of the serving loop (a span "
                         "per step: refill/prefill/sample/record/decode, dispatch vs "
                         "device time); open it in Perfetto")
    ap.add_argument("--no-trace-fence", action="store_true",
                    help="with --trace: no device fence (dispatch-only spans; the launch "
                         "queue is not serialised)")
    ap.add_argument("--metrics-out", default="", metavar="OUT.json",
                    help="write the serving metrics here (a .prom/.txt suffix: Prometheus "
                         "text, else JSON)")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                    help="token archs: admit prompts C tokens at a time through the fused "
                         "decode + prefill step (0 = whole prompts; single-sample only)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="token archs: an N-entry LRU prompt-prefix KV cache (0 = off); "
                         "implies chunked admission")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="P",
                    help="token archs: give every request the same first P prompt tokens "
                         "(prefix-cache hits on the synthetic prompts)")
    ap.add_argument("--mesh", default="",
                    help="token archs of the dense and SSM families (and an ensemble): "
                         "serve on a device mesh, comma-separated axis names (e.g. "
                         "'data,model')")
    ap.add_argument("--mesh-shape", default="",
                    help="per-axis sizes for --mesh, e.g. '2,2' (default: every visible "
                         "card on the last axis); positions share the cards round-robin")
    ap.add_argument("--audit-collectives", action="store_true", help="not ported (ROADMAP)")
    args = ap.parse_args(argv)
    arch = cb.canonical_arch(args.arch)
    if args.mesh_shape and not args.mesh:
        raise SystemExit("--mesh-shape requires --mesh (axis names)")
    if (args.prefill_chunk or args.prefix_cache) and args.ensemble > 1:
        raise SystemExit("--prefill-chunk/--prefix-cache are single-sample serving features; "
                         "K-replica ensemble serving prefills whole prompts")
    if arch in ARCHS:
        if args.prefill_chunk or args.prefix_cache or args.shared_prefix:
            raise SystemExit("--prefill-chunk/--prefix-cache chunk the token-arch prompt "
                             "admission; the classifier path has no prompts")
        if args.trace or args.audit_collectives:
            raise SystemExit("--trace/--audit-collectives instrument the step-level token "
                             "serving loop; the classifier path is fixed-batch (use "
                             "--metrics-out)")
        if args.mesh:
            raise SystemExit("--mesh serving covers the token archs; the classifier path is "
                             "fixed-batch single-device")
        return serve_classifier(arch=arch, binarize=args.binarize, slots=args.slots,
                                requests=64 if args.requests is None else args.requests,
                                seed=args.seed, device=args.device, smoke=args.smoke,
                                plan_out=args.plan, plan_from=args.plan_from,
                                show_report=args.plan_report, override=args.override,
                                analyze=args.analyze, ensemble=args.ensemble,
                                abstain_threshold=args.abstain_threshold,
                                replica_axis=args.replica_axis, metrics_out=args.metrics_out)
    if arch not in cb.ARCH_IDS:
        raise SystemExit(f"unknown --arch {args.arch!r}; one of {', '.join(cb.ARCH_IDS)}")
    for attr, flag, item in _DEFERRED_LM_FLAGS:
        if getattr(args, attr):
            raise SystemExit(f"{flag} is not ported for the token archs yet (ROADMAP {item})")
    return serve_lm(arch=arch, packed=args.packed, binarize=args.binarize,
                    requests=16 if args.requests is None else args.requests,
                    slots=args.slots, prompt_len=args.prompt_len, max_new=args.max_new,
                    max_new_skew=args.max_new_skew, seed=args.seed, device=args.device,
                    smoke=args.smoke, plan_out=args.plan, plan_from=args.plan_from,
                    show_report=args.plan_report, override=args.override, trace=args.trace,
                    trace_fence=not args.no_trace_fence, metrics_out=args.metrics_out,
                    prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
                    shared_prefix=args.shared_prefix, ensemble=args.ensemble,
                    abstain_threshold=args.abstain_threshold,
                    replica_axis=args.replica_axis,
                    mesh=make_serve_mesh(args.mesh, args.mesh_shape, device=args.device))


if __name__ == "__main__":
    main()
