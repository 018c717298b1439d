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
from repro_torch.engine import compile_plan
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.models import mnist_fc, vgg

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
    last_logits: torch.Tensor

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


def serve_classifier(*, arch: str = "mnist_fc", binarize: str = "det",
                     slots: int = C.BATCH_SIZE, requests: int = 64, seed: int = 0,
                     device="cuda", smoke: bool = False) -> ServeResult:
    """Fixed-batch image-classification serving of the paper's nets.
    ``WARMUP_BATCHES`` untimed batches run first and are not counted as
    requests. The plan's mode decides the sign-activation forward."""
    arch = arch.replace("-", "_")
    if slots < 1 or requests < 1:
        raise ValueError("slots and requests must be >= 1")
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tree, apply_fn, kind, n_fc = build_model(arch, seed, device=dev, smoke=smoke)
    params, state = tree["params"], tree["state"]
    plan = compile_plan(params, make_paper_policy(n_fc), binarize)
    params = plan.pack(params, key=prng.key(seed + 1))
    binary_act = plan.mode == "xnor"
    dense_b, packed_b = packed_param_bytes(params)
    print(f"packed weights ({plan.mode}): {dense_b / 1e6:.1f}MB (bf16 dense) -> "
          f"{packed_b / 1e6:.1f}MB ({dense_b / max(packed_b, 1):.1f}x smaller)")

    spec = syn.SyntheticSpec(kind, batch_size=slots, seed=seed)
    with torch.inference_mode():
        for _ in range(WARMUP_BATCHES):
            x, _ = syn.train_batch(spec, 0, device=dev)
            torch.argmax(apply_fn(params, state, x, binary_act=binary_act), dim=-1)
        sync()
        t0, done, lat = time.perf_counter(), 0, []
        for step in range(-(-requests // slots)):
            x, _ = syn.train_batch(spec, step, device=dev)
            t1 = time.perf_counter()
            logits = apply_fn(params, state, x, binary_act=binary_act)
            preds = torch.argmax(logits, dim=-1)
            sync()
            lat.append(time.perf_counter() - t1)
            done += min(slots, requests - done)
    del preds
    res = ServeResult(requests=done, seconds=time.perf_counter() - t0,
                      batch_seconds=lat, warmup=WARMUP_BATCHES, dense_bytes=dense_b,
                      packed_bytes=packed_b, params=params, state=state, last_x=x, last_logits=logits)
    print(f"served {done} requests in {len(lat)} batches of {slots} on {dev}, "
          f"{res.seconds:.3f}s ({res.ms_per_batch:.3f} ms/batch median, "
          f"{res.img_per_s:.1f} img/s)")
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
    args = ap.parse_args(argv)
    return serve_classifier(arch=args.arch, binarize=args.binarize, slots=args.slots,
                            requests=args.requests, seed=args.seed, device=args.device,
                            smoke=args.smoke)


if __name__ == "__main__":
    main()
