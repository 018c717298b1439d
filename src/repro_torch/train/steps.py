"""Train steps implementing the paper's Algorithm 1.

One step =
  1. ``w_b <- binarize(w_{t-1})``            (Eq. 1 or 2, straight-through)
  2. forward + backward against ``w_b``      (gradients land on the masters)
  3. optimizer update of the master weights  (SGD+momentum per the paper)
  4. ``w <- clip(w)``                        (masters stay in [-1, +1])

A step is a plain function of (state, batch): all its randomness comes from
(state key, step), so steps are reproducible and a run restored from a
checkpoint replays bit for bit. Microbatching (gradient accumulation, a
plain loop) and 1-bit gradient compression with error feedback hook in
between (2) and (3).

The state is a dict: ``params`` (master weights), ``opt`` (the optimizer's
slots), ``step`` (an int32 0-d tensor on the CPU: host bookkeeping, read
without a device sync), ``key`` (a ``core.prng.Key``), and, where used,
``model_state`` (batch-norm running stats) and ``err`` (compression
residuals) -- the reference's tree, leaf for leaf.

On the card a step computes in full f32 and deterministically: TF32 is off
for cuBLAS and cuDNN, and cuDNN picks deterministic algorithms, for the
forward and for autograd's backward, which reads those flags when it runs
(``full_f32``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch

from repro_torch.core import binarize, prng
from repro_torch.core.binarize import BinarizeMode
from repro_torch.engine.plan import tree_leaves_with_path, tree_map, tree_unflatten
from repro_torch.optim import compression
from repro_torch.optim.sgd import Optimizer, clip_by_global_norm
from repro_torch.train.losses import accuracy, softmax_xent


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN and cuDNN deterministic (no autotuned
    or atomic algorithms) inside; the global flags are restored after."""
    flags = [(torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def init_train_state(params, optimizer: Optimizer, seed: int = 0, model_state: Any = None,
                     use_compression: bool = False) -> dict:
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32), "key": prng.key(seed)}
    if model_state is not None:
        state["model_state"] = model_state
    if use_compression:
        state["err"] = compression.init_error(params)
    return state


def binarized_value_and_grad(loss_fn: Callable, params, batch, *, mode, policy,
                             key: prng.Key | None, model_state: Any = None,
                             compute_dtype: torch.dtype | None = None):
    """``((loss, aux), grads)`` of ``loss_fn`` at the binarized ``params``
    (Alg. 1 steps 1-2), the grads reaching the masters through the STE;
    ``loss_fn(w_b, batch[, model_state]) -> (loss, aux)``. ``loss`` is
    detached; leaves the loss does not reach get zero grads."""
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in tree_leaves_with_path(params)]
    masters = tree_unflatten(params, leaves)
    with full_f32():
        w_b = binarize.binarize_tree(masters, mode, policy, key)
        if compute_dtype is not None:
            # mixed precision: f32 masters, compute_dtype compute
            w_b = tree_map(lambda x: x.to(compute_dtype) if x.dtype == torch.float32 else x,
                           w_b)
        loss, aux = (loss_fn(w_b, batch) if model_state is None
                     else loss_fn(w_b, batch, model_state))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), aux), tree_unflatten(params, grads)


def _split_microbatches(batch, n: int) -> list:
    return [tree_map(lambda x, i=i: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)],
                     batch) for i in range(n)]


def make_train_step(loss_fn: Callable, optimizer: Optimizer, mode: BinarizeMode | str,
                    policy, *, microbatches: int = 1, grad_clip: Optional[float] = None,
                    use_compression: bool = False, has_model_state: bool = False,
                    compute_dtype: torch.dtype | None = None):
    """Builds the Alg.-1 train step ``(state, batch) -> (new_state, metrics)``.
    ``loss_fn`` returns ``(loss, aux_dict)``; with ``has_model_state`` it
    takes the model state third and ``aux_dict`` holds ``"model_state"``
    (batch-norm running stats). The step key is ``fold_in(key, step)``;
    microbatches average their grads (``/ n``), take the model state the
    step starts from, and report the last microbatch's aux. The masters are
    clipped after the update unless the mode is ``none``."""
    mode = BinarizeMode.parse(mode)

    def step_fn(state, batch):
        step_key = prng.fold_in(state["key"], int(state["step"]))
        model_state = state["model_state"] if has_model_state else None

        def grad_of(mb):
            return binarized_value_and_grad(loss_fn, state["params"], mb, mode=mode,
                                            policy=policy, key=step_key,
                                            model_state=model_state,
                                            compute_dtype=compute_dtype)

        if microbatches > 1:
            losses, gsum = [], None
            for mb in _split_microbatches(batch, microbatches):
                (loss, aux), g = grad_of(mb)
                losses.append(loss)
                g = [x.to(torch.float32) for _, x in tree_leaves_with_path(g)]
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            grads = tree_unflatten(state["params"], [x / microbatches for x in gsum])
            loss = torch.stack(losses).mean()
        else:
            (loss, aux), grads = grad_of(batch)                   # Alg. 1 (1)-(2)

        metrics = {"loss": loss}
        if grad_clip is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip)
        new_state = dict(state)
        if use_compression:                                       # signSGD-EF
            grads, new_state["err"] = compression.compress_tree(grads, state["err"])
        params, opt = optimizer.update(grads, state["opt"], state["params"],
                                       state["step"])             # Alg. 1 (3)
        if mode is not BinarizeMode.NONE:
            params = binarize.clip_tree(params, policy)           # Alg. 1 (4)
        new_state.update(params=params, opt=opt, step=state["step"] + 1)
        aux = dict(aux)
        if has_model_state:
            new_state["model_state"] = aux.pop("model_state")
        for k, v in aux.items():
            if isinstance(v, torch.Tensor) and v.ndim == 0:
                metrics[k] = v.detach()
        return new_state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# Ready-made loss functions
# ---------------------------------------------------------------------------

def make_classifier_loss(apply_fn):
    """For the paper's FC/VGG models (batch-norm state threaded through)."""

    def loss_fn(params, batch, model_state):
        logits, new_state = apply_fn(params, model_state, batch["x"], training=True)
        loss = softmax_xent(logits, batch["y"])
        return loss, {"model_state": new_state,
                      "accuracy": accuracy(logits.detach(), batch["y"])}

    return loss_fn


def make_eval_fn(apply_fn):
    def eval_fn(params, model_state, x, y):
        with torch.no_grad(), full_f32():
            logits = apply_fn(params, model_state, x)
            return softmax_xent(logits, y), accuracy(logits, y)

    return eval_fn


def recalibrate_bn(apply_fn, params, model_state, batches):
    """Re-estimates the batch-norm running stats under a fixed parameter
    tree, one training-mode forward a batch of inputs: needed to evaluate
    a deterministically binarized net trained with stochastic binarization,
    whose training-time stats were accumulated under random sign draws."""
    with torch.no_grad(), full_f32():
        for x in batches:
            model_state = apply_fn(params, model_state, x, training=True)[1]
    return model_state
