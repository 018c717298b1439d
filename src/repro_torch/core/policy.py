"""Binarization policy: which parameters Alg. (1) binarizes.

Projection ("matmul-shaped") weights are binarized; embeddings, norms,
biases, routers, SSM dynamics parameters and the LM head stay full
precision. Paths are '/'-joined tree paths such as ``layers/1/kernel``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

_DEFAULT_EXCLUDE = (
    r".*(^|/)(embed|embedding|pos_embed|frontend)(/|$).*",
    r".*(scale|gamma|beta|bias)$",
    r".*(^|/)(ln|norm|rmsnorm|batchnorm|bn)[^/]*(/|$).*",
    r".*(^|/)router(/|$).*",
    r".*(^|/)(A_log|dt_bias|D|conv)$",
    r".*(^|/)lm_head(/|$).*",
)

_DEFAULT_INCLUDE = (
    r".*(kernel|w_qkv|w_o|w_q|w_k|w_v|wi|wo|w_gate|w_up|w_down|in_proj|out_proj|x_proj)$",
)


@dataclasses.dataclass(frozen=True)
class BinarizePolicy:
    """Selects parameter-tree paths for binarization: a path is selected iff
    it matches any ``include`` pattern and no ``exclude`` pattern."""

    include: Sequence[str] = _DEFAULT_INCLUDE
    exclude: Sequence[str] = _DEFAULT_EXCLUDE

    def __post_init__(self):
        object.__setattr__(self, "_inc", tuple(re.compile(p) for p in self.include))
        object.__setattr__(self, "_exc", tuple(re.compile(p) for p in self.exclude))

    def selects(self, path: str) -> bool:
        if not any(p.fullmatch(path) for p in self._inc):
            return False
        return not any(p.fullmatch(path) for p in self._exc)

    def excluded_by(self, path: str) -> str | None:
        """The first exclude pattern blocking an otherwise-included path
        (None if the path is selected or matches no include pattern)."""
        if not any(p.fullmatch(path) for p in self._inc):
            return None
        for p in self._exc:
            if p.fullmatch(path):
                return p.pattern
        return None


#: Paper-faithful default policy.
DEFAULT_POLICY = BinarizePolicy()

#: Binarize nothing (the paper's "No Regularizer" baseline).
NONE_POLICY = BinarizePolicy(include=())


def make_paper_policy(n_fc_layers: int) -> BinarizePolicy:
    """BNN convention the paper follows: binarize hidden projections; the
    input layer (first conv / first FC) and the classifier head stay full
    precision."""
    last = n_fc_layers - 1
    return BinarizePolicy(
        include=(r".*(kernel)$",),
        exclude=(r"(layers|fc)/0/kernel", rf"(layers|fc)/{last}/kernel",
                 r".*bn.*", r"conv/0/kernel"),
    )


# Layers whose *inputs* are real-valued stay off the binary-activation path:
# index 0 of ``layers/`` (FC nets) or ``fc/`` (the VGG head) consumes raw
# pixels or conv features, and VGG's first conv block (``conv/0..1``) sits
# closest to the raw pixels. This is an activation boundary only: the weight
# policy still binarizes conv/1's weights, and they serve binarized-dense.
_XNOR_EXTRA_EXCLUDE = (
    r"(^|.*/)(layers|fc)/0/[^/]+$",
    r"(^|.*/)conv/[01]/kernel$",
)

#: Which weight-binarized leaves may also binarize their activations and
#: dispatch to the XNOR-popcount engine (``repro_torch.xnor``). A leaf must
#: be selected by both the weight policy and this one to become an
#: XnorLinear or XnorConv.
XNOR_POLICY = BinarizePolicy(exclude=_DEFAULT_EXCLUDE + _XNOR_EXTRA_EXCLUDE)


def xnor_policy(extra_exclude: Sequence[str] = ()) -> BinarizePolicy:
    """XNOR eligibility with model-specific real-valued-input layers added."""
    return BinarizePolicy(
        exclude=_DEFAULT_EXCLUDE + _XNOR_EXTRA_EXCLUDE + tuple(extra_exclude))


_XNOR_BOUNDARY_RES = tuple(re.compile(p) for p in _XNOR_EXTRA_EXCLUDE)


def is_xnor_boundary(path: str) -> bool:
    """True iff ``path`` is excluded from binary activations because its
    input is real-valued (the first-layer / first-conv-block patterns), as
    opposed to a generic policy exclusion. The plan compiler phrases the
    row's reason with it."""
    return any(p.fullmatch(path) for p in _XNOR_BOUNDARY_RES)


_CONV_KERNEL_RE = re.compile(r"(^|.*/)conv/\d+/kernel$")


def is_conv_kernel(path: str) -> bool:
    """2-D conv-stack kernels (``conv/<i>/kernel``, 4-D HWIO leaves)."""
    return bool(_CONV_KERNEL_RE.fullmatch(path))
