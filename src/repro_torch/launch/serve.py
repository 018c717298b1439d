"""Serving driver: fixed-batch inference of the paper's nets (the MNIST FC
net and VGG-16 on CIFAR-10) with binary weights, and in ``xnor`` mode binary
activations too.

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

Plan manifests, as the reference's serve: ``--plan OUT.json`` saves the
compiled plan, ``--plan-from IN.json`` serves a saved one (its mode
supersedes ``--binarize``), ``--plan-report`` prints the per-layer
backend/bytes/reason table, ``--override PATH=BACKEND`` forces a layer
(path or '/'-prefix) onto a backend, and ``--analyze`` runs the plan lints
and exits 1 on an error finding:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vgg16_cifar10 \
      --binarize xnor --override conv/3=binarized_dense --plan-report

Stochastic ensemble: ``--ensemble K`` (with ``--binarize stoch``) draws K
packed replicas of every stochastic layer, classifies from the
ensemble-mean logits and reports the replicas' vote agreement;
``--abstain-threshold A`` counts the images whose agreement is below A:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mnist_fc \
      --binarize stoch --ensemble 8 --abstain-threshold 0.6

Runs on the CUDA device unless ``--device cpu`` is given; asking for CUDA
where there is none raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import time
from typing import Any

import torch

from repro_torch.configs import mnist_fc as C
from repro_torch.configs import vgg16_cifar10 as VC
from repro_torch.core import prng
from repro_torch.core.policy import make_paper_policy
from repro_torch.data import synthetic as syn
from repro_torch.engine import ExecutionPlan, compile_plan, format_plan_table, plan_report
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.models import mnist_fc, vgg
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


def packed_param_bytes(params) -> tuple[int, int]:
    """(dense bf16 bytes, served bytes): a serving leaf counts its master
    shape on the dense side (never its word count, which includes pad words)
    and its words and scale on the served side; every other leaf counts its
    bf16 size on both sides."""
    dense = packed = 0
    for _, leaf in tree_leaves_with_path(params):
        if hasattr(leaf, "master_shape"):
            dense += math.prod(leaf.master_shape) * 2
            packed += leaf.nbytes()
        else:
            dense += leaf.numel() * 2
            packed += leaf.numel() * 2
    return dense, packed


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
              replica_axis: str = "data") -> ExecutionPlan:
    """Compiles (or loads) the execution plan and runs the requested plan
    I/O, as the reference's ``make_plan``. A loaded plan is authoritative:
    its mode decides the packing and the sign-activation forward, whatever
    ``binarize`` says."""
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
                            overrides=parse_overrides(override) or None,
                            replica_axis=replica_axis if ensemble > 1 else None)
    if ensemble > 1 and plan.replica_axis is None:
        # a v2 manifest, or one compiled without an ensemble: adopt the CLI's
        plan.replica_axis = replica_axis
    if plan_out:
        print(f"plan manifest -> {plan.save(plan_out)}")
    if show_report:
        print(format_plan_table(plan_report(plan, batch=report_batch)))
    return plan


def serve_classifier(*, arch: str = "mnist_fc", binarize: str = "det",
                     slots: int = C.BATCH_SIZE, requests: int = 64, seed: int = 0,
                     device="cuda", smoke: bool = False, with_scale: bool = True,
                     plan_out: str = "", plan_from: str = "", show_report: bool = False,
                     override=(), analyze: bool = False, ensemble: int = 1,
                     abstain_threshold: float | None = None,
                     replica_axis: str = "data") -> ServeResult:
    """Fixed-batch image-classification serving of the paper's nets.
    ``WARMUP_BATCHES`` untimed batches run first and are not counted as
    requests. The plan's mode decides the sign-activation forward.

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
    if findings is not None:
        from repro_torch.analysis import format_findings, gate

        print(format_findings(findings, title="static verifier (plan lints):"))
        if gate(findings):
            raise SystemExit(1)
    return res


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mnist_fc",
                    choices=list(ARCHS) + ["vgg16-cifar10"])
    ap.add_argument("--binarize", default="det", choices=["det", "stoch", "xnor"])
    ap.add_argument("--slots", type=int, default=C.BATCH_SIZE,
                    help="images per batch (the paper's batch is 4)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the plain versions")
    ap.add_argument("--smoke", action="store_true",
                    help=f"mnist_fc hidden widths {C.SMOKE_HIDDEN} instead of {C.HIDDEN}; "
                         f"vgg16_cifar10 width_mult {VC.SMOKE_WIDTH_MULT}")
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
                    help="serve a K-replica stochastic ensemble (needs --binarize stoch): "
                         "classify from the mean logits, report vote agreement")
    ap.add_argument("--abstain-threshold", type=float, default=None,
                    help="count a request as abstained when its replica vote agreement "
                         "is below this (needs --ensemble >= 2)")
    ap.add_argument("--replica-axis", default="data", choices=["data", "model"],
                    help="mesh axis the ensemble replica dim shards over (recorded in "
                         "the plan manifest, v3)")
    args = ap.parse_args(argv)
    return serve_classifier(arch=args.arch, binarize=args.binarize, slots=args.slots,
                            requests=args.requests, seed=args.seed, device=args.device,
                            smoke=args.smoke, plan_out=args.plan, plan_from=args.plan_from,
                            show_report=args.plan_report, override=args.override,
                            analyze=args.analyze, ensemble=args.ensemble,
                            abstain_threshold=args.abstain_threshold,
                            replica_axis=args.replica_axis)


if __name__ == "__main__":
    main()
