"""Built-in layer backends: dense, binarized_dense, packed_conv, packed,
xnor and xnor_conv.

Priority order (highest wins among eligible), as in the reference:

  xnor_conv (40) > xnor (30) > packed (20) > packed_conv (15)
    > binarized_dense (10) > dense (0)

* ``packed`` binarizes a (K, N) projection, or each (K, N) slice of a
  stacked (L, K, N) or (L, E, K, N) one (Eq. 1, or Eq. 2 with words from
  the pack key, ``core.prng``), and bitpacks it with K1, then serves it
  with K2; a layer's MoE experts (E, K/32, N) in one expert-batched K2
  launch.
* ``xnor`` packs the same way (Eq. 1) and serves with K3 (sign + pack the
  activations) and K4 (XNOR-popcount matmul). It takes ``SignWords`` too:
  the model then runs the producer's bias, batch norm and sign inside K3.
  It serves no MoE experts, as the reference does not.
* ``xnor_conv`` packs a conv kernel in the per-tap layout with K1 (its
  ``XnorConv`` leaf keeps the per-tap weight sums the border correction
  reads) and serves with K5 (patch packing) and K4, whose flush adds the
  correction and applies the scale.
* ``packed_conv`` (stoch only) packs a conv kernel along the flat kh*kw*C
  axis with K1 and, at apply time, unpacks in plain torch and runs the dense
  conv, as the reference unpacks with jnp outside any kernel.
* ``binarized_dense`` keeps a binarized conv kernel (+-1 [* scale]) dense.
* ``dense`` keeps the master weight: ``torch.matmul``, or ``F.conv2d`` in
  full f32, as the reference leaves dense layers to XLA.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import binarize as B
from repro_torch.core import prng
from repro_torch.core.binarize import BinarizeMode
from repro_torch.core.packing import PACK, unpack_bits
from repro_torch.engine import costs
from repro_torch.engine.registry import (BackendSpec, LeafContext, PackContext,
                                         register_backend)
from repro_torch.kernels import ops
from repro_torch.models.layers import (PackedConv, PackedLinear, SignWords, XnorConv,
                                       XnorLinear, conv2d_nhwc)
from repro_torch.xnor import ops as xops
from repro_torch.xnor.conv import ops as cops
from repro_torch.xnor.conv.packing import conv_geometry, pack_conv_kernel

# ---------------------------------------------------------------------------
# eligibility (reason strings copied from the reference, which the golden
# plan manifests record)
# ---------------------------------------------------------------------------


def _dense_eligible(lc: LeafContext) -> tuple[bool, str]:
    return True, "ok"


def _packable(lc: LeafContext) -> tuple[bool, str]:
    """Gate for the bitpacked-weight matmul backends."""
    if not lc.selected:
        return False, "policy-excluded"
    if lc.is_conv:
        return False, "conv kernel (no packed-weight MXU conv lowering)"
    if lc.ndim < 2:
        return False, f"ndim={lc.ndim} < 2 (not matmul-shaped)"
    if lc.shape[-2] % PACK != 0:
        return False, f"K={lc.shape[-2]} % {PACK} != 0"
    return True, "ok"


def _xnor_gate(lc: LeafContext) -> tuple[bool, str]:
    """Mode and activation-policy gate of the fully-binary backends."""
    if lc.mode != "xnor":
        return False, f"mode={lc.mode} != xnor"
    if not lc.xnor_selected:
        return False, ("xnor-policy-excluded (real-valued-input boundary)"
                       if lc.xnor_boundary else "xnor-policy-excluded")
    return True, "ok"


def _xnor_eligible(lc: LeafContext) -> tuple[bool, str]:
    ok, why = _packable(lc)
    return _xnor_gate(lc) if ok else (ok, why)


def _conv_selected(lc: LeafContext) -> tuple[bool, str]:
    if not lc.is_conv:
        return False, "not a conv-stack kernel"
    if not lc.selected:
        return False, "policy-excluded"
    return True, "ok"


def _xnor_conv_eligible(lc: LeafContext) -> tuple[bool, str]:
    ok, why = _conv_selected(lc)
    return _xnor_gate(lc) if ok else (ok, why)


def _packed_conv_eligible(lc: LeafContext) -> tuple[bool, str]:
    """Bitpacked conv weights, stoch mode only (1-bit storage is what a
    stochastic ensemble needs; in det/xnor mode binarized_dense is free)."""
    ok, why = _conv_selected(lc)
    if not ok:
        return ok, why
    if lc.mode != "stoch":
        return False, f"mode={lc.mode} != stoch (dense ±1 fallback is free)"
    return True, "ok"


# ---------------------------------------------------------------------------
# pack transforms
# ---------------------------------------------------------------------------


def _pack_dense(lc: LeafContext, leaf, pc: PackContext):
    return leaf


def _missing_key_error(lc: LeafContext) -> ValueError:
    """The reference's 'no PRNG key' error, naming the leaf that failed."""
    return ValueError(
        f"stochastic packing requires a PRNG key, but none was supplied "
        f"for leaf {lc.path!r} (leaf index {lc.index}): pass "
        f"key=repro_torch.core.prng.key(seed) to plan.pack(...), "
        f"or compile the plan with mode='det' for keyless deterministic "
        f"binarization")


def _leaf_key(lc: LeafContext, pc: PackContext) -> prng.Key | None:
    """The key the leaf's Eq.-2 words come from (the pack key folded with
    the leaf index), or None when the leaf binarizes by Eq. 1."""
    if pc.weight_mode is not BinarizeMode.STOCHASTIC:
        return None
    if pc.key is None:
        raise _missing_key_error(lc)
    return prng.fold_in(pc.key, lc.index)


def _conv_scale(leaf: torch.Tensor, pc: PackContext) -> torch.Tensor | None:
    """Per-output-channel mean |w| of a (kh, kw, C, N) kernel, or None when
    the plan packs without scales."""
    return leaf.to(torch.float32).abs().mean(dim=(0, 1, 2)) if pc.with_scale else None


def _pack_binarized_dense(lc: LeafContext, leaf: torch.Tensor, pc: PackContext):
    """Binarized values (+-1 [* scale]) kept dense: the Alg.-1 inference
    network for conv layers with no bitpacked lowering."""
    scale = _conv_scale(leaf, pc)
    key = _leaf_key(lc, pc)
    wb = B.deterministic_binarize(leaf) if key is None else B.stochastic_binarize(leaf, key)
    return wb if scale is None else (wb.to(torch.float32) * scale).to(leaf.dtype)


class _LinearPacker:
    """Binarizes + bitpacks a stacked (..., K, N) projection of ``shape``
    into ``cls`` through K1, one (K, N) matrix at a time (``put(l, w)``, l
    row-major over the leading dims), into words and scales allocated once
    on ``device``; ``leaf()`` is the serving leaf. The scale (unless the
    plan packs without) is the mean |w| over K, (..., N). Matrix l's Eq.-2
    words come from ``split(fold_in(key, index), L)[l]``, the keys the
    reference's vmap over the L matrices draws from (L = 1 for a 2-D
    leaf)."""

    def __init__(self, cls, lc: LeafContext, shape, pc: PackContext, device):
        *lead, k, n = shape
        count = math.prod(lead)
        key = _leaf_key(lc, pc)
        self._cls, self._lead, self._k = cls, tuple(lead), k
        self._keys = None if key is None else prng.split(key, count)
        self._words = torch.empty((count, -(-k // PACK), n), dtype=torch.int32,
                                  device=device)
        self._scale = (torch.empty((count, n), dtype=torch.float32, device=device)
                       if pc.with_scale else None)

    def put(self, i: int, w: torch.Tensor) -> None:
        self._words[i] = (ops.binarize_and_pack(w) if self._keys is None
                          else ops.binarize_and_pack(w, self._keys[i], stochastic=True))
        if self._scale is not None:
            self._scale[i] = w.to(torch.float32).abs().mean(dim=0)

    def leaf(self):
        n = self._words.shape[-1]
        scale = None if self._scale is None else self._scale.view(*self._lead, n)
        return self._cls(self._words.view(*self._lead, -1, n), scale, self._k)


def _pack_linear(cls, lc: LeafContext, leaf: torch.Tensor, pc: PackContext):
    """:class:`_LinearPacker` over every (K, N) matrix of a master leaf."""
    packer = _LinearPacker(cls, lc, tuple(leaf.shape), pc, leaf.device)
    for i, w in enumerate(leaf.reshape(-1, *leaf.shape[-2:])):
        packer.put(i, w)
    return packer.leaf()


def _pack_packed_conv(lc: LeafContext, leaf: torch.Tensor, pc: PackContext):
    """Stochastic binarize + bitpack a (kh, kw, C, N) kernel along the flat
    kh*kw*C axis through K1 (stoch mode only, so the key is required); the
    words come from ``fold_in(key, index)``, with no split."""
    kh, kw, c_in, n = leaf.shape
    if pc.key is None:
        raise _missing_key_error(lc)
    packed = ops.binarize_and_pack(leaf.reshape(kh * kw * c_in, n),
                                   prng.fold_in(pc.key, lc.index), stochastic=True)
    return PackedConv(packed, _conv_scale(leaf, pc), (kh, kw), c_in)


def _pack_xnor_conv(lc: LeafContext, leaf: torch.Tensor, pc: PackContext):
    kh, kw, c_in, _ = leaf.shape
    return XnorConv(pack_conv_kernel(leaf), _conv_scale(leaf, pc), (kh, kw), c_in)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_dense(w: torch.Tensor, x: torch.Tensor, *, stride=None, padding=None):
    if stride is None:
        return x @ w.to(x.dtype)
    _, _, pads = conv_geometry(x.shape[1], x.shape[2], w.shape[:2], stride, padding)
    return conv2d_nhwc(x, w.to(x.dtype), stride, pads)


def _apply_packed(w: PackedLinear, x: torch.Tensor, rows=None) -> torch.Tensor:
    """x @ w; a layer's experts (words (E, K/32, N), x (E, C, K)) in one
    expert-batched launch, which computes only each expert's first
    ``rows[e]`` rows (all C if None)."""
    if w.packed.ndim == 3:
        return ops.binary_matmul_batched(x, w.packed, w.scale, rows).to(x.dtype)
    return ops.binary_matmul(x, w.packed, w.scale).to(x.dtype)


#: Why an MoE layer's experts have no xnor datapath: a fact of the reference.
XNOR_EXPERTS_ABSENT = (
    "xnor MoE experts: the reference's models/moe.py _expert_matmul "
    "(src/repro/models/moe.py:22-34) takes no XnorLinear (its decode fails on an "
    "xnor-packed MoE tree), so the MoE family serves in det and stoch only")


def _apply_xnor(w: XnorLinear, x: torch.Tensor | SignWords, rows=None) -> torch.Tensor:
    if w.packed.ndim == 3:
        raise NotImplementedError(XNOR_EXPERTS_ABSENT)
    if isinstance(x, SignWords):     # signs packed by the producer's fused K3
        if x.k != w.k:
            raise ValueError(f"sign words cover k={x.k}, the leaf k={w.k}")
        return xops.xnor_matmul_packed(x.words, w.packed, w.scale, k=w.k,
                                       out_dtype=torch.float32)
    return xops.xnor_matmul(x, w.packed, w.scale, k=w.k,
                            out_dtype=torch.float32).to(x.dtype)


def row_partial(w, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel shard's partial product, ``x`` its range of the
    contraction: an xnor shard's int32 popcount dot of its word range, with
    no scale (K3 + K4 on the range; partials sum exactly), or a dense
    shard's f32 product. A mesh position runs it; the sum is an all-reduce
    (``distributed.sharding.sharded_linear``)."""
    if isinstance(w, XnorLinear):
        return xops.xnor_matmul(x, w.packed, None, k=w.k)
    if isinstance(w, torch.Tensor):
        return _apply_dense(w, x).to(torch.float32)
    raise NotImplementedError(f"no row-parallel route for a {type(w).__name__} leaf "
                              f"(only xnor and dense shard their contraction dim)")


def row_finish(w, total: torch.Tensor, dtype) -> torch.Tensor:
    """The summed partials of :func:`row_partial` as the unsharded apply
    returns them: xnor scales the int32 sum once, ``f32(dot) * scale`` as
    K4's flush does, then casts to ``dtype``."""
    if isinstance(w, XnorLinear):
        out = total.to(torch.float32)
        if w.scale is not None:
            out = out * w.scale.to(torch.float32).to(out.device)
        return out.to(dtype)
    return total.to(dtype)


def _apply_packed_conv(w: PackedConv, x: torch.Tensor, *, stride=(1, 1), padding="SAME"):
    wb = unpack_bits(w.packed, dtype=torch.float32)[: w.k]   # drop the ragged pad
    if w.scale is not None:
        wb = wb * w.scale.to(torch.float32)[None, :]
    wk = wb.reshape(*w.ksize, w.c_in, w.packed.shape[-1])
    return _apply_dense(wk, x, stride=stride, padding=padding)


def _apply_xnor_conv(w: XnorConv, x: torch.Tensor, *, stride=(1, 1), padding="SAME"):
    out = cops.xnor_conv2d(x, w.packed, w.scale, ksize=w.ksize, c_in=w.c_in,
                           stride=stride, padding=padding, out_dtype=torch.float32,
                           tap_sums=w.tap_sums)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

DENSE = register_backend(BackendSpec(
    name="dense", kinds=("linear", "conv"), priority=0, leaf_type=None,
    eligible=_dense_eligible, pack=_pack_dense, apply=_apply_dense,
    cost=functools.partial(costs.gemm_cost, "dense"),
    doc="Full-width master weights: torch.matmul, or F.conv2d in full f32."))

BINARIZED_DENSE = register_backend(BackendSpec(
    name="binarized_dense", kinds=("conv",), priority=10, leaf_type=None,
    eligible=_conv_selected, pack=_pack_binarized_dense, apply=_apply_dense,
    cost=functools.partial(costs.gemm_cost, "binarized_dense"), tp_dim=-1,
    doc="Conv fallback: Alg.-1 binarized values (+-1 * scale) stored densely."))

PACKED_CONV = register_backend(BackendSpec(
    name="packed_conv", kinds=("conv",), priority=15, leaf_type=PackedConv,
    eligible=_packed_conv_eligible, pack=_pack_packed_conv, apply=_apply_packed_conv,
    cost=functools.partial(costs.gemm_cost, "packed"), tp_dim=-1,
    doc="Stoch-mode conv: K1-bitpacked binary kernel, unpacked to +-1 * scale "
        "for the dense conv at apply time."))

PACKED = register_backend(BackendSpec(
    name="packed", kinds=("linear",), priority=20, leaf_type=PackedLinear,
    eligible=_packable,
    pack=lambda lc, leaf, pc: _pack_linear(PackedLinear, lc, leaf, pc),
    matrix_packer=functools.partial(_LinearPacker, PackedLinear),
    apply=_apply_packed, cost=functools.partial(costs.gemm_cost, "packed"), tp_dim=-1,
    doc="Bitpacked binary weights (+ per-channel scale) through the K2 "
        "packed-weight matmul kernel."))

XNOR = register_backend(BackendSpec(
    name="xnor", kinds=("linear",), priority=30, leaf_type=XnorLinear,
    eligible=_xnor_eligible,
    pack=lambda lc, leaf, pc: _pack_linear(XnorLinear, lc, leaf, pc),
    apply=_apply_xnor, takes_sign_words=True,
    cost=functools.partial(costs.gemm_cost, "xnor"),
    # integer popcount partial sums all-reduce exactly, so xnor alone may
    # shard a row-parallel projection's contraction dim
    tp_dim=-1, tp_contract_dim=-2,
    doc="Fully-binary FC: binary weights and sign-packed activations (K3, or "
        "SignWords from the producer's fused K3), XNOR-popcount dot (K4)."))

XNOR_CONV = register_backend(BackendSpec(
    name="xnor_conv", kinds=("conv",), priority=40, leaf_type=XnorConv,
    eligible=_xnor_conv_eligible, pack=_pack_xnor_conv, apply=_apply_xnor_conv,
    cost=functools.partial(costs.gemm_cost, "xnor_conv"), tp_dim=-1,
    doc="Fully-binary conv: packed im2col patches (K5) + popcount matmul (K4) "
        "+ border correction."))
