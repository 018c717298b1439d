"""Inputs that hold K3's producer prologue (``kernel.bn_sign_pack``) and
``kernel.bn_sign`` to their plain chain, the sweep that holds the
prologue's rsqrt to ``torch.rsqrt``, the values on either side of Eq. 1's
threshold (``core.binarize.SIGN_MIN``) that every sign site is held to, and
a subnormal planted at each step the chain flushes; shared by the port's
tests and ``chip_smoke.py``.

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


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# Values either side of Eq. 1's threshold 2^-126, each with the sign bit
# Eq. 1 gives it (1 only at 2^-126 and above), as f32 bit patterns and as
# bf16 ones (the top 16 bits of an f32): the smallest subnormal, a subnormal
# in the middle (2^-127) and the largest, each of both signs, 2^-126 and
# the next value above it, -2^-126, +-0 and NaN.
SIGN_PLANTS = {
    torch.float32: [(0x00000001, 0), (0x80000001, 0), (0x00400000, 0), (0x80400000, 0),
                    (0x007FFFFF, 0), (0x807FFFFF, 0), (0x00800000, 1), (0x00800001, 1),
                    (0x80800000, 0), (0x00000000, 0), (0x80000000, 0), (0x7FC00000, 0)],
    torch.bfloat16: [(0x0001, 0), (0x8001, 0), (0x0040, 0), (0x8040, 0), (0x007F, 0),
                     (0x807F, 0), (0x0080, 1), (0x0081, 1), (0x8080, 0), (0x0000, 0),
                     (0x8000, 0), (0x7FC0, 0)],
}


_F32_EPS = np.float32(BN_EPS)
VAR_ONE = float(np.float32(1) - _F32_EPS)                        # var + eps == 1
VAR_2M40 = float(np.nextafter(-_F32_EPS, np.float32(0)))          # var + eps == 2^-40

# A subnormal at each step of the flushed chain (``kernel.bn_sign_plain``):
# the six inputs, then x + bias, - mean, var + eps, * inv_std, * scale and
# + shift. Each row: (step, h, bias, bn_scale, bn_bias, mean, var, eps, the
# reference's sign bit). Every value and every unflushed intermediate is
# exact in f32, and where the sign depends on the flush the chain without
# it signs the other way (the subnormal result of + shift signs -1 either
# way, the result of - mean is the ROADMAP's smallest case). With eps = 0
# a subnormal var is also a subnormal var + eps: with eps = 1e-5, var + eps
# is a multiple of 2^-41 and cannot be subnormal.
FLUSH_PLANTS = [
    ("h", 2.0 ** -135, 0.0, 1.0, 0.0, 0.0, VAR_2M40, BN_EPS, 0),
    ("bias", 0.0, 2.0 ** -135, 1.0, 0.0, 0.0, VAR_2M40, BN_EPS, 0),
    ("x + bias", 2.0 ** -125, -31 * 2.0 ** -130, 1.0, 0.0, 0.0, VAR_2M40, BN_EPS, 0),
    ("mean", 0.0, 0.0, 1.0, 0.0, -(2.0 ** -135), VAR_2M40, BN_EPS, 0),
    ("- mean", 2.0 ** -125, 0.0, 2.0 ** 20, 0.0, 31 * 2.0 ** -130, VAR_ONE, BN_EPS, 0),
    ("var, var + eps", 0.0, 0.0, 1.0, 2.0 ** -100, 0.0, 2.0 ** -140, 0.0, 0),
    ("* inv_std", 2.0 ** -65, 0.0, 2.0 ** 20, 0.0, 0.0, 2.0 ** 126, BN_EPS, 0),
    ("bn_scale", 2.0 ** 30, 0.0, 2.0 ** -140, 0.0, 0.0, VAR_ONE, BN_EPS, 0),
    ("* bn_scale", 0.5, 0.0, -(2.0 ** -126), 2.0 ** -126, 0.0, VAR_ONE, BN_EPS, 1),
    ("bn_bias", 1.0, 0.0, 2.0 ** -126, -(2.0 ** -127), 0.0, VAR_ONE, BN_EPS, 1),
    ("+ bn_bias", 1.0, 0.0, 2.0 ** -125, -31 * 2.0 ** -130, 0.0, VAR_ONE, BN_EPS, 0),
]


def flush_cases(m: int, device, reps: int = 5) -> list[tuple[float, tuple, torch.Tensor]]:
    """``(eps, case, bits)`` for each eps of :data:`FLUSH_PLANTS`: a case of
    M rows whose columns are that eps's plants, repeated ``reps`` times
    (so K is ragged for reps = 5), and the 0/1 bit each column signs to."""
    out = []
    for eps in sorted({p[7] for p in FLUSH_PLANTS}):
        rows = [p for p in FLUSH_PLANTS if p[7] == eps] * reps
        cols = list(zip(*(p[1:7] for p in rows)))
        h = torch.tensor(cols[0], dtype=torch.float32).expand(m, -1).contiguous()
        vecs = [torch.tensor(c, dtype=torch.float32) for c in cols[1:]]
        bits = torch.tensor([p[8] for p in rows], dtype=torch.int64)
        out.append((eps, tuple(t.to(device) for t in (h, *vecs)), bits))
    return out


def sign_plants(dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, bits): the planted values of ``dtype`` (f32 or bf16) on the
    CPU and the 0/1 sign bits Eq. 1 gives them, as int64."""
    pats, bits = zip(*SIGN_PLANTS[dtype])
    if dtype == torch.float32:
        vals = torch.tensor([_f32(b) for b in pats], dtype=torch.float32)
    else:
        vals = torch.tensor([_f32(b << 16) for b in pats], dtype=torch.float32).to(dtype)
    return vals, torch.tensor(bits, dtype=torch.int64)


def plant_signs(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with :func:`sign_plants` of its dtype written along ``dim``, at
    the positions i with i % 16 < 12 (plant i % 16); returns the 0/1 bits
    Eq. 1 gives those positions (-1 elsewhere), one per index of ``dim``."""
    vals, bits = sign_plants(x.dtype)
    n = x.shape[dim]
    idx = torch.arange(n)
    planted = idx % 16 < len(vals)
    want = torch.full((n,), -1, dtype=torch.int64)
    want[planted] = bits[idx[planted] % 16]
    view = x.movedim(dim, -1)
    view[..., planted.to(x.device)] = vals[idx[planted] % 16].to(x.device)
    return want


def plant_bn_signs(case: tuple[torch.Tensor, ...]) -> tuple[tuple[torch.Tensor, ...],
                                                           torch.Tensor]:
    """Plants :func:`sign_plants` (f32) as BN outputs of a ``bn_inputs``
    case made with subnormals: in the columns c with c % 16 in 9..15,
    y = 0 * inv_std * 1 + shift = shift exactly; ``bn_inputs`` planted +0,
    -0.0, NaN and +-2^-149 at c % 16 < 6. Returns the case and the 0/1 bits
    Eq. 1 gives each planted column (-1 where a column is random)."""
    h, bias, scale, shift, mean, var = (t.clone() for t in case)
    vals, bits = sign_plants(torch.float32)
    slots = {9: 2, 10: 3, 11: 4, 12: 5, 13: 6, 14: 7, 15: 8}   # c % 16 -> plant
    k = h.shape[1]
    want = torch.full((k,), -1, dtype=torch.int64)
    for c in range(k):
        if c % 16 < _PLANTS:
            want[c] = 0                    # bn_inputs' plants all sign -1
        plant = slots.get(c % 16)
        if plant is None:
            continue
        h[:, c] = mean[c]
        bias[c], scale[c], shift[c] = 0.0, 1.0, vals[plant]
        var[c] = var[c].abs() + 0.5
        want[c] = bits[plant]
    return (h, bias, scale, shift, mean, var), want


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
    on ``device`` for every positive normal f32 ``var`` (eps = 0; the
    prologue flushes a subnormal var + eps to 0 first, as the reference
    does, so its rsqrt never sees one), through
    ``bn_sign_pack`` itself, ``chunk`` values a launch: with h = 1, bias =
    mean = 0, scale = s and shift = -s * torch.rsqrt(var), y is
    s * (kernel's rsqrt - torch's), exactly, so a bit is set where the two
    differ (s = 1: the kernel's is larger; s = -1: smaller). A control on
    the first chunk: 1 ulp below torch's value sets every bit. Returns the
    number of values checked; raises where they differ."""
    from repro_torch.xnor.kernel import bn_sign_pack

    first, end = 0x00800000, 0x7F800000   # 2^-126 .. the largest finite f32
    checked = 0
    ones = torch.ones((1, chunk), device=device)
    zeros = torch.zeros(chunk, device=device)
    for start in range(first, end, chunk):
        n = min(chunk, end - start)
        var = torch.arange(start, start + n, dtype=torch.int32, device=device).view(
            torch.float32)
        r = torch.rsqrt(var)
        for s in (1.0, -1.0):
            words = bn_sign_pack(ones[:, :n], zeros[:n], torch.full_like(r, s), -s * r,
                                 zeros[:n], var, eps=0.0)
            if bool(words.any()):
                where = start + int(torch.nonzero(
                    torch.repeat_interleave(words[0] != 0, 32)[:n])[0])
                raise AssertionError(
                    f"rsqrt sweep: the kernel's rsqrt differs from torch.rsqrt near "
                    f"bit pattern {where:#x} ({'above' if s > 0 else 'below'})")
        if start == first:
            below = torch.nextafter(r[:4096], zeros[:4096])
            ctrl = bn_sign_pack(ones[:, :4096], zeros[:4096], ones[0, :4096], -below,
                                zeros[:4096], var[:4096], eps=0.0)
            if not bool((ctrl == -1).all()):
                raise AssertionError("rsqrt sweep: the control missed a 1-ulp difference")
        checked += n
    return checked
