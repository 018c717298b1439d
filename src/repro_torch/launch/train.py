"""Training entry point (the paper's "host controller").

Trains the paper's nets (``--arch mnist_fc``, ``vgg16_cifar10``) with the
paper's recipe (Alg. 1: SGD momentum 0.9, eta0 1e-3 with the Eq.-4 decay,
batch norm, batch 4), or any LM architecture (its full or ``--smoke``
config) with the next-token loss on the synthetic token stream, on Alg. 1
with SGD momentum at a constant rate or AdamW with a cosine schedule. The
frontend architectures (musicgen, internvl2) train on tokens here, as the
reference's CLI trains them. Fault tolerance is on: async checkpoints and
auto-resume; ``--fail-at`` injects simulated crashes to watch the run
restore and replay.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist_fc \
      --binarize stoch --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist_fc \
      --binarize stoch --device cpu --smoke --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \
      --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --binarize det --steps 100 --batch 8 --seq 128

Runs on the CUDA device unless ``--device cpu`` is given; asking for CUDA
where there is none raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import base as cb
from repro_torch.configs import mnist_fc as C
from repro_torch.configs import vgg16_cifar10 as VC
from repro_torch.core.policy import DEFAULT_POLICY, NONE_POLICY, make_paper_policy
from repro_torch.data import synthetic as syn
from repro_torch.engine.plan import tree_leaves_with_path
from repro_torch.ft.failures import FailureInjector
from repro_torch.launch.serve import ARCHS, build_model, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import schedules
from repro_torch.optim.sgd import adamw, sgd_momentum
from repro_torch.train import steps as ST
from repro_torch.train.trainer import Trainer, TrainerConfig

#: Checkpoints go under the checkout's git-ignored ``build/`` unless
#: ``--ckpt-dir`` says otherwise.
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"
N_TRAIN = {"mnist_fc": 60_000, "vgg16_cifar10": 50_000}


def build_paper_model(arch: str, *, binarize: str = "det", batch: int | None = None,
                      smoke: bool = False, seed: int = 0, compress: bool = False,
                      device="cuda"):
    """``(state, step_fn, batch_fn)`` for one of the paper's nets under its
    recipe: weights drawn from ``seed`` on ``device``, the paper's policy
    (hidden projections binarized, the first and last layers full
    precision), Eq.-4 SGD momentum and the classifier loss."""
    dev = resolve_device(device)
    recipe = C if arch == "mnist_fc" else VC
    tree, apply_fn, kind, n_fc = build_model(arch, seed, device=dev, smoke=smoke)
    spec = syn.SyntheticSpec(kind, batch_size=batch or recipe.BATCH_SIZE, seed=seed,
                             n_train=N_TRAIN[arch])
    opt = sgd_momentum(schedules.paper_eq4(recipe.LEARNING_RATE, spec.steps_per_epoch),
                       momentum=recipe.MOMENTUM)
    step_fn = ST.make_train_step(
        ST.make_classifier_loss(apply_fn), opt, binarize,
        make_paper_policy(n_fc) if binarize != "none" else NONE_POLICY,
        has_model_state=True, use_compression=compress)
    state = ST.init_train_state(tree["params"], opt, seed=seed, model_state=tree["state"],
                                use_compression=compress)

    def batch_fn(step):
        x, y = syn.train_batch(spec, step, device=dev)
        return {"x": x, "y": y}

    return state, step_fn, batch_fn


def build_lm(arch: str, *, binarize: str = "det", batch: int = 8, seq: int = 128,
             lr: float = 3e-3, optimizer: str = "sgd", microbatches: int = 1,
             smoke: bool = False, seed: int = 0, compress: bool = False, steps: int = 200,
             n_layers: int | None = None, device="cuda"):
    """``(state, step_fn, batch_fn)`` for an LM architecture, as the
    reference's ``build_lm``: masters drawn from ``seed`` on ``device``
    (``init_lm``), ``DEFAULT_POLICY`` (``NONE_POLICY`` for ``none``), SGD
    momentum at the constant ``lr`` or AdamW with a cosine schedule (20
    warmup steps over ``steps``), the next-token loss, and batches
    ``{"tokens": lm_tokens(...)}``. ``n_layers`` cuts the depth."""
    dev = resolve_device(device)
    cfg = cb.get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = T.init_lm(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(leaf.numel() for _, leaf in tree_leaves_with_path(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params (smoke={smoke}, binarize={binarize})")
    opt = (adamw(schedules.cosine(lr, 20, steps)) if optimizer == "adamw"
           else sgd_momentum(schedules.constant(lr)))
    step_fn = ST.make_train_step(
        ST.make_lm_loss(cfg), opt, binarize,
        DEFAULT_POLICY if binarize != "none" else NONE_POLICY,
        microbatches=microbatches, use_compression=compress)
    state = ST.init_train_state(params, opt, seed=seed, use_compression=compress)
    spec = syn.SyntheticSpec("lm", batch_size=batch, seed=seed, n_train=1 << 30,
                             seq_len=seq, vocab_size=cfg.vocab_size)

    def batch_fn(step):
        return {"tokens": syn.lm_tokens(spec, step, device=dev)}

    return state, step_fn, batch_fn


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True,
                    help=f"{', '.join(cb.ARCH_IDS)} (or an alias)")
    ap.add_argument("--binarize", default="det", choices=["none", "det", "stoch"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: the paper's 4 for its nets, 8 for an LM)")
    ap.add_argument("--seq", type=int, default=128, help="LM tokens a row")
    ap.add_argument("--lr", type=float, default=3e-3, help="LM learning rate")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"],
                    help="LM optimizer: SGD momentum (constant rate) or AdamW (cosine)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="LM gradient accumulation over this many microbatches")
    ap.add_argument("--smoke", action="store_true", help="narrow widths")
    ap.add_argument("--compress", action="store_true",
                    help="1-bit gradient compression with error feedback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated failures at these steps")
    ap.add_argument("--history-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    arch = cb.canonical_arch(args.arch)
    if arch in ARCHS:
        state, step_fn, batch_fn = build_paper_model(
            arch, binarize=args.binarize, batch=args.batch, smoke=args.smoke,
            seed=args.seed, compress=args.compress, device=args.device)
    elif arch in cb.ARCH_IDS:
        state, step_fn, batch_fn = build_lm(
            arch, binarize=args.binarize, batch=args.batch or 8, seq=args.seq, lr=args.lr,
            optimizer=args.optimizer, microbatches=args.microbatches, smoke=args.smoke,
            seed=args.seed, compress=args.compress, steps=args.steps, device=args.device)
    else:
        raise SystemExit(f"unknown --arch {args.arch!r}")
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_dir=f"{args.ckpt_dir}/{arch}_{args.binarize}",
                      checkpoint_every=args.ckpt_every),
        step_fn, batch_fn, state,
        failure_injector=FailureInjector(tuple(args.fail_at)) if args.fail_at else None)
    start = trainer.current_step()
    t0 = time.perf_counter()
    history = trainer.run()
    seconds = time.perf_counter() - t0
    last = history[-1] if history else {}
    steps = trainer.current_step() - start
    print(f"done: {len(history)} logged steps, recoveries={trainer.recoveries}, "
          f"final={json.dumps(last)}")
    print(f"{arch} {args.binarize} on {args.device}: {steps} steps in {seconds:.2f} s "
          f"({steps / seconds if seconds else 0.0:.2f} steps/s, checkpoints included)")
    if args.history_out:
        trainer.save_history(args.history_out)
    return trainer


if __name__ == "__main__":
    main()
