"""Inputs that hold K3's producer prologue (``kernel.bn_sign_pack``) to the
unfused chain it replaces, and the sweep that holds its rsqrt to
``torch.rsqrt``; shared by the port's tests and ``chip_smoke.py``.

A case is ``(h, bias, bn_scale, bn_bias, mean, var)``: (M, K) f32
activations and five (K,) f32 vectors, in ``bn_sign_pack``'s order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import BN_EPS

# (M, K): the serving shapes (mnist_fc's hidden layers, VGG's fc/0), ragged
# K, and M * K/32 words past the grid's 65,535 blocks of 8 warps
FUSED_SHAPES = [(4, 2048), (4, 512), (3, 31), (7, 100), (5, 2049)]
PAST_GRID_SHAPE = (8200, 2048)

# planted columns, by c % 16: y = +0, -0.0, NaN (var < 0), +-the smallest
# subnormal (or +-1), NaN (0 * rsqrt(0) = 0 * inf); the rest stay random
_PLANTS = 6
_TINY = float(np.array(1, np.int32).view(np.float32))     # 2^-149


def bn_inputs(m: int, k: int, seed: int, device, *,
              subnormals: bool = True) -> tuple[torch.Tensor, ...]:
    """Random activations and batch-norm parameters (scale of either sign)
    from a numpy seed, with BN outputs planted that need no rounding to
    reach: they are the same on every device. ``subnormals=False`` plants
    +-1 in place of +-2^-149, which the reference's XLA CPU flushes to 0
    (ROADMAP, queue 3)."""
    tiny = _TINY if subnormals else 1.0
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, k)).astype(np.float32)
    bias = rng.normal(0, 0.1, k).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, k) * rng.choice([-1.0, 1.0], k)).astype(np.float32)
    shift = rng.normal(0, 0.1, k).astype(np.float32)
    mean = rng.normal(0, 0.5, k).astype(np.float32)
    var = rng.uniform(0.5, 4.0, k).astype(np.float32)
    for c in range(k):
        plant = c % 16
        if plant >= _PLANTS:
            continue
        # x + 0 - mean == 0 exactly: y = 0 * inv_std * scale + shift
        h[:, c], bias[c], mean[c] = mean[c], 0.0, mean[c]
        scale[c], shift[c] = [(1.0, 0.0), (-1.0, -0.0), (1.0, 0.0), (1.0, tiny),
                              (1.0, -tiny), (1.0, 0.0)][plant]
        if plant == 2:
            var[c] = -1.0                                   # rsqrt < 0: NaN
        elif plant == 5:
            var[c] = -np.float32(BN_EPS)                    # var + eps == 0: inf
    return tuple(torch.from_numpy(a).to(device) for a in (h, bias, scale, shift, mean, var))


def plant_near_zero(case: tuple[torch.Tensor, ...],
                    eps: float = BN_EPS) -> tuple[torch.Tensor, ...]:
    """Sets ``bn_bias`` in the columns c % 16 in 6..8 so that row c % M's BN
    output is exactly 0, or one step of ``bn_bias`` above or below it.

    The step is computed by the chain itself on the case's device, so only
    a prologue that rounds every operation as the chain does gives the
    chain's bits there: one FMA for ``y * scale + shift`` leaves the
    product's rounding error instead of 0."""
    h, bias, scale, shift, mean, var = case
    m, k = h.shape
    cols = torch.arange(k, device=h.device)
    rows = cols % m
    prod = ((h[rows, cols] + bias) - mean) * torch.rsqrt(var + eps) * scale
    target = -prod
    up, down = (torch.nextafter(target, torch.full_like(target, v))
                for v in (float("inf"), float("-inf")))
    plant = cols % 16
    shift = torch.where(plant == 6, target, torch.where(plant == 7, up, torch.where(
        plant == 8, down, shift)))
    return h, bias, scale, shift, mean, var


def rsqrt_sweep(device, chunk: int = 1 << 27) -> int:
    """Holds the prologue's ``rsqrt(var + eps)`` equal to ``torch.rsqrt(var)``
    on ``device`` for every positive finite f32 ``var`` (eps = 0), through
    ``bn_sign_pack`` itself, ``chunk`` values a launch: with h = 1, bias =
    mean = 0, scale = s and shift = -s * torch.rsqrt(var), y is
    s * (kernel's rsqrt - torch's), exactly, so a bit is set where the two
    differ (s = 1: the kernel's is larger; s = -1: smaller). A control on
    the first chunk: 1 ulp below torch's value sets every bit. Returns the
    number of values checked; raises where they differ."""
    from repro_torch.xnor.kernel import bn_sign_pack

    end = 0x7F800000                   # bit patterns 1 .. 0x7F7FFFFF: positive finite
    checked = 0
    ones = torch.ones((1, chunk), device=device)
    zeros = torch.zeros(chunk, device=device)
    for start in range(1, end, chunk):
        n = min(chunk, end - start)
        var = torch.arange(start, start + n, dtype=torch.int32, device=device).view(
            torch.float32)
        r = torch.rsqrt(var)
        for s in (1.0, -1.0):
            words = bn_sign_pack(ones[:, :n], zeros[:n], torch.full_like(r, s), -s * r,
                                 zeros[:n], var, eps=0.0)
            if bool(words.any()):
                first = start + int(torch.nonzero(
                    torch.repeat_interleave(words[0] != 0, 32)[:n])[0])
                raise AssertionError(
                    f"rsqrt sweep: the kernel's rsqrt differs from torch.rsqrt near "
                    f"bit pattern {first:#x} ({'above' if s > 0 else 'below'})")
        if start == 1:
            below = torch.nextafter(r[:4096], zeros[:4096])
            ctrl = bn_sign_pack(ones[:, :4096], zeros[:4096], ones[0, :4096], -below,
                                zeros[:4096], var[:4096], eps=0.0)
            if not bool((ctrl == -1).all()):
                raise AssertionError("rsqrt sweep: the control missed a 1-ulp difference")
        checked += n
    return checked
