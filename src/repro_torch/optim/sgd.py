"""Optimizers as pure (init, update) pairs over parameter trees (dicts and
lists of tensors): SGD+momentum (the paper's choice) and AdamW.

The training algorithm's weight clip (Alg. 1 step 4) is applied by the
train step after the optimizer update, through ``core.binarize.clip_tree``,
which keeps the optimizers generic. Updates are functional: new tensors,
the inputs untouched.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.engine.plan import tree_leaves_with_path, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def _map_n(fn, *trees) -> list:
    """``fn`` over the trees' leaves in step (the trees share a structure);
    returns one list of results, in leaf order."""
    return [fn(*leaves) for leaves in zip(*map(_leaves, trees))]


def sgd_momentum(schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                 momentum_dtype: torch.dtype | None = None) -> Optimizer:
    """SGD with (heavy-ball) momentum and a rate schedule.
    ``momentum_dtype`` keeps the momentum slot in a reduced dtype (bf16
    halves optimizer memory); None keeps the params' dtype."""

    def init(params):
        if momentum_dtype is None:
            return {"mu": tree_map(torch.zeros_like, params)}
        return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=momentum_dtype,
                                                     device=p.device), params)}

    def update(grads, state, params, step):
        lr = schedule(step)

        def upd(g, m, p):
            g = g.to(torch.float32)
            if weight_decay:
                g = g + weight_decay * p.to(torch.float32)
            m_new = momentum * m.to(torch.float32) + g
            p_new = p.to(torch.float32) - lr * m_new
            return p_new.to(p.dtype), m_new.to(m.dtype)

        flat = _map_n(upd, grads, state["mu"], params)
        return (tree_unflatten(params, (t[0] for t in flat)),
                {"mu": tree_unflatten(params, (t[1] for t in flat))})

    return Optimizer(init, update)


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        lr = schedule(step)
        t = step.to(torch.float32) + 1.0
        c1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * torch.square(g)
            direction = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            p32 = p.to(torch.float32)
            p_new = p32 - lr * (direction + weight_decay * p32)
            return p_new.to(p.dtype), m_new, v_new

        flat = _map_n(upd, grads, state["m"], state["v"], params)
        return (tree_unflatten(params, (t[0] for t in flat)),
                {"m": tree_unflatten(params, (t[1] for t in flat)),
                 "v": tree_unflatten(params, (t[2] for t in flat))})

    return Optimizer(init, update)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.to(torch.float32)))
                                   for x in _leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * factor).to(g.dtype), grads), norm
