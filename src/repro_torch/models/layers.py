"""Base layers: linear and conv application (dense, bitpacked binary, or
fully binary), batch norm (eval and training mode), the fused batch-norm
sign of the fully-binary path, the He initializer, and the LM layers (the
scaled-normal initializers and a leaf's draw order, RMS and layer norm,
rotary embeddings and the embedding lookup, each upcasting to f32 where the
reference does).

Models are binarization-agnostic: the serving path substitutes serving
leaves (:class:`PackedLinear`, :class:`XnorLinear`, :class:`XnorConv`,
:class:`PackedConv`) for master weights, and ``apply_linear`` /
``apply_conv2d`` dispatch on the leaf type through the ``repro_torch.engine``
registry, so the same model code serves every datapath. Convolutions are
NHWC/HWIO at every interface, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import torch
import torch.nn.functional as F

BN_EPS = 1e-5     # batch norm's variance epsilon, as the reference's


def _nbytes(packed: torch.Tensor, scale: torch.Tensor | None) -> int:
    """Bytes stored by a serving leaf: the packed words plus the scale."""
    return packed.numel() * 4 + (0 if scale is None else scale.numel() * 4)


@dataclasses.dataclass
class _LinearLeaf:
    """Bitpacked (..., K, N) weight: words, optional per-column scale, true
    K. Leading dims stack layers (an LM's (L, K, N) leaves); ``leaf[i]`` is
    layer i's leaf."""

    packed: torch.Tensor             # (*lead, ceil(k / 32), N) int32
    scale: torch.Tensor | None       # (*lead, N) f32 or None
    k: int                           # true contraction size

    @property
    def master_shape(self) -> tuple[int, ...]:
        """The master weight's (*lead, K, N), whatever pad words the layout
        holds."""
        return (*self.packed.shape[:-2], self.k, self.packed.shape[-1])

    def __getitem__(self, i: int):
        if self.packed.ndim < 3:
            raise IndexError(f"a {tuple(self.packed.shape)} leaf has no stacked dim")
        return type(self)(self.packed[i], None if self.scale is None else self.scale[i],
                          self.k)

    def nbytes(self) -> int:
        return _nbytes(self.packed, self.scale)

    def to(self, device):
        return type(self)(self.packed.to(device),
                          None if self.scale is None else self.scale.to(device), self.k)


@dataclasses.dataclass
class PackedLinear(_LinearLeaf):
    """Bitpacked binary weight: ``unpack(packed)[:k] * scale`` of shape (k, N)."""


@dataclasses.dataclass
class XnorLinear(_LinearLeaf):
    """Fully-binary linear: weights bitpacked like :class:`PackedLinear`, and
    activations sign-binarized and bitpacked on the fly, so the dot product
    is an integer XNOR-popcount (``repro_torch.xnor``)."""


@dataclasses.dataclass
class _ConvLeaf:
    """Bitpacked (kh, kw, C, N) conv kernel: words, optional per-channel
    scale, kernel size and input channels."""

    packed: torch.Tensor             # int32 words, layout set by the subclass
    scale: torch.Tensor | None       # (N,) f32 or None
    ksize: tuple[int, int]           # (kh, kw)
    c_in: int                        # input channels

    @property
    def k(self) -> int:
        """True contraction length kh*kw*c_in."""
        return self.ksize[0] * self.ksize[1] * self.c_in

    @property
    def master_shape(self) -> tuple[int, ...]:
        """The master (kh, kw, C, N), with the true C."""
        return (*self.ksize, self.c_in, self.packed.shape[-1])

    def nbytes(self) -> int:
        return _nbytes(self.packed, self.scale)

    def to(self, device):
        return type(self)(self.packed.to(device),
                          None if self.scale is None else self.scale.to(device),
                          self.ksize, self.c_in)


@dataclasses.dataclass
class XnorConv(_ConvLeaf):
    """Fully-binary 2-D convolution: the kernel is bitpacked along kh*kw*C in
    the per-tap word layout, (kh*kw*ceil(c_in/32), N) int32
    (``repro_torch.xnor.conv``); at apply time the input is packed into
    im2col patches on the fly.

    ``tap_sums`` (kh*kw, N) int32 holds sum_c sign(w)[tap, c, n], read off the
    words once, when the leaf is made (pack time, interop or ``.to``): the
    border correction of every later call reads it. It is derived from
    ``packed``, so ``nbytes`` counts the words and scale only, as the
    reference's leaf stores them."""

    tap_sums: torch.Tensor | None = None

    def __post_init__(self):
        if self.tap_sums is None:
            from repro_torch.xnor.conv.packing import kernel_tap_sums

            self.tap_sums = kernel_tap_sums(self.packed, self.ksize, self.c_in)

    def to(self, device):
        return XnorConv(self.packed.to(device),
                        None if self.scale is None else self.scale.to(device),
                        self.ksize, self.c_in, self.tap_sums.to(device))


@dataclasses.dataclass
class PackedConv(_ConvLeaf):
    """Bitpacked binary-weight conv with real-valued activations: the
    kernel is bitpacked along the flattened kh*kw*C axis (flat FC word
    layout, (ceil(kh*kw*c_in/32), N) int32) and unpacked to +-1 [* scale]
    for the ordinary dense conv at apply time."""


@dataclasses.dataclass(frozen=True)
class SignWords:
    """An activation (..., k) given as its Eq.-1 signs, bitpacked along the
    last axis (``xnor.packing`` layout): what a backend whose spec has
    ``takes_sign_words`` reads in place of the real values."""

    words: torch.Tensor              # (..., ceil(k / 32)) int32
    k: int


def takes_sign_words(w) -> bool:
    """Whether the backend serving the linear leaf ``w`` reads
    :class:`SignWords`."""
    from repro_torch.engine import registry

    return registry.backend_for_leaf(w, "linear").takes_sign_words


def bn_sign_words(x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> SignWords:
    """The Eq.-1 signs of ``batch_norm(x + bias, scale, shift, mean, var)``
    as :class:`SignWords`: K3 computes the bias, the batch norm and the sign
    in its load, and gives the bits the unfused chain gives."""
    from repro_torch.xnor import ops as xops

    return SignWords(xops.bn_sign_and_pack(x, bias, scale, shift, mean, var), x.shape[-1])


def bn_sign(x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """The Eq.-1 sign (+-1 f32) of ``batch_norm(x + bias, scale, shift, mean,
    var)``, in x's shape (batch norm over the last axis): one kernel
    computes the bias, the batch norm and the sign, with the reference's
    flushes (``xnor.kernel.bn_sign_plain``). The sign sites whose consumer
    reads floats take it."""
    from repro_torch.xnor import ops as xops

    return xops.bn_sign(x, bias, scale, shift, mean, var)


def apply_linear(w, x, bias: torch.Tensor | None = None, *,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ bias); the leaf type of ``w`` selects its backend. ``x`` is a
    tensor, or :class:`SignWords` where ``takes_sign_words(w)`` holds.
    ``rows`` (E,): for an MoE expert leaf, each expert's live rows of x."""
    from repro_torch.engine import registry

    out = registry.apply_linear(w, x, rows)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def apply_conv2d(w, x: torch.Tensor, bias: torch.Tensor | None = None, *,
                 stride=(1, 1), padding="SAME") -> torch.Tensor:
    """conv2d(x, w) (+ bias), NHWC/HWIO; the leaf type of ``w`` selects its
    backend."""
    from repro_torch.engine import registry

    out = registry.apply_conv2d(w, x, stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride, pads) -> torch.Tensor:
    """conv2d of an NHWC input with an HWIO kernel and explicit
    ((ph0, ph1), (pw0, pw1)) zero padding, returned NHWC. ``F.conv2d`` wants
    NCHW/OIHW, so the permutes happen here and nowhere else. cuDNN's TF32 is
    switched off for the call (its default is on), so an f32 conv stays full
    f32 on the card; the global flag is restored after."""
    (ph0, ph1), (pw0, pw1) = pads
    xc = x.permute(0, 3, 1, 2)
    if (ph0, pw0) == (ph1, pw1):
        pad = (ph0, pw0)
    else:
        xc, pad = F.pad(xc, (pw0, pw1, ph0, ph1)), 0
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(stride), padding=pad)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out.permute(0, 2, 3, 1)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, VALID, NHWC in and out."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def he_normal(generator: torch.Generator, shape, *, device,
              dtype=torch.float32, fan_in: int | None = None) -> torch.Tensor:
    """He initialization (the paper's choice for FC nets)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = (2.0 / max(fan_in, 1)) ** 0.5
    return std * torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, *, training: bool = False,
               momentum: float = 0.9, eps: float = BN_EPS, axes=(0,)):
    """Batch norm over the last axis, in f32.

    Eval mode (the default) normalises with the running stats and returns
    y. Training mode normalises with the batch mean and population variance
    over ``axes`` (gradients flow through both) and returns
    ``(y, new_mean, new_var)``, the running stats moved by ``momentum`` as
    the reference moves them; no gradient flows into the new stats."""
    x32 = x.to(torch.float32)
    if not training:
        y = (x32 - mean) * torch.rsqrt(var + eps)
        return (y * scale + bias).to(x.dtype)
    mu = x32.mean(dim=axes)
    va = x32.var(dim=axes, correction=0)
    with torch.no_grad():
        new_mean = momentum * mean + (1.0 - momentum) * mu
        new_var = momentum * var + (1.0 - momentum) * va
    y = (x32 - mu) * torch.rsqrt(va + eps)
    return (y * scale + bias).to(x.dtype), new_mean, new_var


def layer_batch_norm(x: torch.Tensor, lp: dict, ls: dict, *, training: bool,
                     new_state: list, axes=(0,)) -> torch.Tensor:
    """A model layer's batch norm: its ``bn_scale`` and ``bn_bias`` params
    (``lp``) and its running ``mean`` and ``var`` (``ls``); in training mode
    the moved stats are appended to ``new_state``."""
    if not training:
        return batch_norm(x, lp["bn_scale"], lp["bn_bias"], ls["mean"], ls["var"])
    x, m, v = batch_norm(x, lp["bn_scale"], lp["bn_bias"], ls["mean"], ls["var"],
                         training=True, axes=axes)
    new_state.append({"mean": m, "var": v})
    return x


# ---------------------------------------------------------------------------
# LM layers
# ---------------------------------------------------------------------------


def lm_init(generator: torch.Generator, shape, *, device, dtype=torch.float32,
            fan_in: int | None = None) -> torch.Tensor:
    """Scaled-normal init for transformer projections: std fan_in^-1/2,
    fan_in the second-to-last dim by default (so stacked (L, K, N) leaves
    init per layer)."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    return fan_in ** -0.5 * torch.randn(tuple(shape), generator=generator, device=device,
                                        dtype=dtype)


@dataclasses.dataclass(frozen=True)
class LeafDraw:
    """How one master leaf at ``path`` is drawn: in one call (``whole``:
    (generator, device) -> the leaf), or, a scaled-normal projection
    (``fan_in``), either over its whole stacked shape in one ``init_fn``
    call (:func:`draw_leaves`: the uniform and SSM templates) or one (K, N)
    matrix at a time, row-major over the leading dims, each
    ``lm_init(generator, (K, N), fan_in=fan_in)`` (:meth:`materialize`: the
    hybrid template). The module inits state their leaves once this way
    (``attn_draws``, ``mlp_draws``, ``moe_draws``, ``ssm_draws``). A list
    of these, in order, is a model's draw order: walking it with one
    generator makes the same generator calls whether the leaves are kept
    (:meth:`materialize`) or each matrix is consumed as it is drawn
    (``ExecutionPlan.pack_drawn``)."""

    path: str
    shape: tuple[int, ...]
    whole: Callable | None = None
    fan_in: int | None = None

    def under(self, prefix: str) -> "LeafDraw":
        """This draw with its path under ``prefix``."""
        return dataclasses.replace(self, path=f"{prefix}/{self.path}")

    def matrices(self, generator: torch.Generator, device) -> Iterator[torch.Tensor]:
        """The leaf's (K, N) matrices in draw order (a matrix-drawn leaf)."""
        for _ in range(math.prod(self.shape[:-2])):
            yield lm_init(generator, self.shape[-2:], fan_in=self.fan_in, device=device)

    def materialize(self, generator: torch.Generator, device) -> torch.Tensor:
        """The whole leaf, f32, each projection drawn a matrix at a time."""
        if self.whole is not None:
            return self.whole(generator, device)
        out = torch.empty(self.shape, device=device)
        flat = out.view(-1, *self.shape[-2:])
        for i, w in enumerate(self.matrices(generator, device)):
            flat[i] = w
        return out


def filled(path: str, shape, value: float = 0.0) -> LeafDraw:
    """A leaf that draws nothing: f32 ``value`` everywhere."""
    shape = tuple(shape)
    return LeafDraw(path, shape, whole=lambda g, dev: torch.full(shape, value, device=dev))


def draw_leaves(draws, generator: torch.Generator, init_fn, *, device) -> dict:
    """{path: leaf} of ``draws``, drawn in order, each projection whole by
    one ``init_fn(generator, shape, fan_in=..., device=...)`` call."""
    return {d.path: (d.whole(generator, device) if d.whole is not None
                     else init_fn(generator, d.shape, fan_in=d.fan_in, device=device))
            for d in draws}


def tree_from_paths(pairs) -> dict:
    """A nested dict from ('/'-joined path, leaf) pairs (a draw order's
    paths)."""
    out: dict = {}
    for path, leaf in pairs:
        *heads, last = path.split("/")
        node = out
        for head in heads:
            node = node.setdefault(head, {})
        node[last] = leaf
    return out


def embed_init(generator: torch.Generator, shape, *, device,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in f32, with the weight
    ``1 + scale``; returns x's dtype.

    The mean of squares is summed in f64 and rounded to f32 once, so a row's
    norm does not depend on how many rows share the call: torch's f32
    reduction picks its summation order by the tensor's shape, and a norm
    one ulp off can flip an MoE layer's near-tie expert, so a served stream
    would differ from the same request decoded alone."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x.to(torch.float64)), dim=-1,
                     keepdim=True).to(torch.float32)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, (B, S, 1, head_dim/2) f32, for
    positions (B, S) or (S,): one table serves the q and k of a call."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) rotated by a :func:`rope_cos_sin` table, in f32;
    returns x's dtype."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd) rotated by its positions ((B, S) or (S,))."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``embedding`` (V, D) at ``tokens`` (any shape), cast to ``dtype``."""
    rows = embedding.index_select(0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, embedding.shape[-1]).to(dtype)
