"""Learning-rate schedules, including the paper's Eq. (4) adaptive decay.

Eq. (4):  eta[epoch] = eta[epoch-1] * 0.01 ** (epoch / 100)

which in closed form is  eta[E] = eta[0] * 0.01 ** (sum_{e=1..E} e / 100)
                               = eta[0] * 0.01 ** (E * (E + 1) / 200).

A schedule maps the step (an int32 0-d tensor) to the rate, an f32 0-d
tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def paper_eq4(eta0: float, steps_per_epoch: int):
    """The paper's adaptive decaying learning rate, evaluated per step."""

    def schedule(step):
        epoch = torch.div(step, max(steps_per_epoch, 1), rounding_mode="floor").to(
            torch.float32)
        exponent = epoch * (epoch + 1.0) / 200.0
        return torch.full_like(epoch, eta0) * torch.pow(torch.full_like(epoch, 0.01), exponent)

    return schedule


def constant(lr: float):
    def schedule(step):
        return torch.full(step.shape, lr, dtype=torch.float32, device=step.device)

    return schedule


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def schedule(step):
        step = step.to(torch.float32)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return schedule
