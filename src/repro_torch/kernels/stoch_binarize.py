"""K1 wrapper: fused (deterministic | stochastic) binarize + bitpack.

``binarize_pack(w, bits, stochastic=...)`` maps a (K, N) f32/bf16 master
weight to (ceil(K/32), N) int32 words (``core.packing`` layout). The
stochastic rule thresholds caller-supplied uniform uint32 words (passed as
int32 bit patterns) against hard_sigmoid(w), exactly as the reference's
operand variant does, so both sides can be fed the same words.

``binarize_pack(w, key=k, draw_cols=d, stochastic=True)`` thresholds the
words the reference's caller draws for it, ``jax.random.bits(k, (., d))``
cut to (K, N) (:func:`threefry_words`): on a card the kernel computes them
in its loop (the threefry mode), so they never reach memory; on the CPU
they are drawn by the twin (``core.prng``) and fed to the operand rule.
This is the route ``kernels.ops.binarize_and_pack`` takes.

``binarize_pack(w, stochastic=True, seed=s, on_chip_prng=True)`` is the
counterpart of the reference's ``use_tpu_prng=True`` variant: the kernel
draws its own words from a stateless Philox4x32-10 stream, where word
(k, n) depends only on (seed, k, n) (:func:`onchip_words`). No path calls
it.

A CPU tensor runs the plain version in ``kernels.ref`` (a block of
``HOST_BLOCK`` weights at a time, but for the on-chip variant); a CUDA
tensor launches ``csrc/binarize_pack.cu`` or raises.
``binarize_pack.launches`` counts kernel launches, and
``binarize_pack.launches_threefry`` and ``binarize_pack.launches_on_chip``
those of the threefry mode and the on-chip variant among them.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.packing import PACK, pad_to_pack, to_int32
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DET, _OPERAND, _ON_CHIP, _THREEFRY = 0, 1, 2, 3     # the kernel's modes (csrc/binarize_pack.cu)

# Philox4x32-10 (Salmon et al., SC'11): round multipliers and Weyl key bumps
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * m, for uint32 values
    ``a`` held in int64 and a constant m < 2^32. Both multipliers are above
    2^31, so the product overflows int64: ``a`` is split into 16-bit halves,
    each partial product stays below 2^48, and the halves are recombined."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of a 4-word counter under a 2-word key, elementwise.

    Words are uint32 values held in int64 tensors (or Python ints, which
    broadcast); returns the four output words, each masked to 32 bits."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (int(k) & _MASK32 for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def onchip_words(seed: int, k: int, n: int, device=None) -> torch.Tensor:
    """The (k, n) uniform words the on-chip variant draws, as int32 bit
    patterns: u[r, c] = philox4x32_10((r >> 2, c, 0, 0), (seed mod 2^32, 0))[r & 3],
    which depends on (seed, r, c) only, never on the launch shape."""
    rows = torch.arange((k + 3) // 4, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    out = philox4x32_10((rows, cols, 0, 0), (seed, 0))
    lanes = torch.stack([o.expand(rows.shape[0], n) for o in out], dim=1)  # (k/4, 4, n)
    return to_int32(lanes.reshape(-1, n)[:k])


def threefry_words(key: prng.Key, k: int, n: int, draw_cols: int,
                   device=None) -> torch.Tensor:
    """The (k, n) words the threefry mode thresholds, as int32 bit patterns:
    ``prng.bits(key, (k, draw_cols))[:, :n]``, i.e. word (r, c) is the
    reference's ``jax.random.bits`` word at row-major index r * draw_cols + c
    of any draw with ``draw_cols`` columns."""
    words = prng.bits(key, (k, draw_cols), device)
    return words if draw_cols == n else words[:, :n]


def binarize_pack_plain(w: torch.Tensor, bits: torch.Tensor | None, *,
                        stochastic: bool, seed: int | None = None,
                        on_chip_prng: bool = False) -> torch.Tensor:
    """The plain torch version of :func:`binarize_pack`, on any device. The
    threefry mode's is the operand rule's on :func:`threefry_words`."""
    wp = pad_to_pack(w, axis=0)   # -1 rows pack to bit 0 under both rules
    if not stochastic:
        return ref.det_binarize_pack_ref(wp)
    if on_chip_prng:
        return ref.stoch_binarize_pack_ref(wp, onchip_words(seed, *wp.shape, device=w.device))
    bp = torch.zeros(wp.shape, dtype=torch.int32, device=w.device)
    bp[: w.shape[0]] = bits
    return ref.stoch_binarize_pack_ref(wp, bp)


# Elements of a block of a CPU pack: under torch's intra-op grain size
# (2^15), so each op of a block runs on the calling thread.
HOST_BLOCK = (1 << 15) - 1


def _host_plain(w: torch.Tensor, bits: torch.Tensor | None, *,
                stochastic: bool) -> torch.Tensor:
    """:func:`binarize_pack_plain` of a CPU leaf, a block of up to
    ``HOST_BLOCK`` weights (whole word rows of 32 weight rows, and at most
    ``HOST_BLOCK // 32`` columns) at a time: the same words, since a word
    packs 32 rows of one column. Whole-leaf ops would each wait on the
    thread pool's barrier, many times over when several processes share
    the CPU."""
    k, n = w.shape
    cols = min(n, HOST_BLOCK // PACK)
    rows = PACK * max(1, HOST_BLOCK // (PACK * cols))
    if rows >= k and cols >= n:
        return binarize_pack_plain(w, bits, stochastic=stochastic)
    return torch.cat([
        torch.cat([binarize_pack_plain(w[r:r + rows, c:c + cols],
                                       None if bits is None else bits[r:r + rows, c:c + cols],
                                       stochastic=stochastic)
                   for c in range(0, n, cols)], dim=1)
        for r in range(0, k, rows)])


def binarize_pack(w: torch.Tensor, bits: torch.Tensor | None = None, *,
                  stochastic: bool, seed: int | None = None,
                  on_chip_prng: bool = False, key: prng.Key | None = None,
                  draw_cols: int | None = None) -> torch.Tensor:
    """(K, N) master weight [+ (K, N) int32 words] -> (ceil(K/32), N) int32.

    The stochastic rule takes exactly one source of words: ``bits``, a
    ``key`` (the threefry mode: :func:`threefry_words` of ``key`` over
    ``draw_cols`` >= N columns, N when None), or ``on_chip_prng=True`` (the
    reference's ``use_tpu_prng``) with a ``seed`` (:func:`onchip_words`).
    ``seed`` is given exactly when ``on_chip_prng`` is set, ``draw_cols``
    only with a ``key``."""
    if w.ndim != 2 or w.shape[0] == 0 or w.shape[1] == 0:
        raise ValueError(f"w must be a non-empty (K, N) matrix, got {tuple(w.shape)}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if on_chip_prng != (seed is not None):
        raise ValueError("a seed is given exactly when on_chip_prng=True")
    if draw_cols is not None and key is None:
        raise ValueError("draw_cols goes with a key")
    k, n = w.shape
    sources = (bits is not None) + (key is not None) + on_chip_prng
    if not stochastic:
        if sources:
            raise ValueError("stochastic=False takes no bits, key or on_chip_prng")
    elif sources != 1:
        raise ValueError("stochastic=True takes exactly one of bits, key and "
                         "on_chip_prng=True")
    if bits is not None and (bits.shape != w.shape or bits.dtype != torch.int32):
        raise ValueError(f"bits must be int32 of shape {tuple(w.shape)}, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    if key is not None:
        draw_cols = n if draw_cols is None else int(draw_cols)
        if draw_cols < n:
            raise ValueError(f"draw_cols must be at least N = {n}, got {draw_cols}")
    if _build.kernel_device("binarize_pack", [w] + ([bits] if bits is not None else [])) == "cpu":
        if on_chip_prng:
            return binarize_pack_plain(w, None, stochastic=True, seed=seed, on_chip_prng=True)
        if key is not None:
            bits = threefry_words(key, k, n, draw_cols)
        return _host_plain(w, bits, stochastic=stochastic)
    out = torch.empty(((k + PACK - 1) // PACK, n), dtype=torch.int32, device=w.device)
    mode = (_ON_CHIP if on_chip_prng else _THREEFRY if key is not None
            else _OPERAND if stochastic else _DET)
    k0, k1 = (key.k0, key.k1) if key is not None else (0, 0)
    lib = _build.library()
    code = lib.bnn_binarize_pack(
        w.data_ptr(), bits.data_ptr() if bits is not None else None, out.data_ptr(),
        k, n, _DTYPES[w.dtype], mode, int(seed or 0) & _MASK32, k0, k1,
        draw_cols or 0, _build.stream(w.device))
    _build.check(code, "binarize_pack")
    binarize_pack.launches += 1
    if mode == _ON_CHIP:
        binarize_pack.launches_on_chip += 1
    elif mode == _THREEFRY:
        binarize_pack.launches_threefry += 1
    return out


binarize_pack.launches = 0
binarize_pack.launches_on_chip = 0   # the on-chip-PRNG launches among them
binarize_pack.launches_threefry = 0  # the threefry mode's launches among them
