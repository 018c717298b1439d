"""Config system: model/arch configs, input shapes, and the registry (a
data copy of the reference's ``repro/configs/base.py``).

Every LM architecture has a ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (full size, the assigned hyperparameters) and ``SMOKE`` (a reduced
config of the same family for CPU tests). ``--arch <id>`` in the launchers
resolves through :func:`get_config`. ``activation_dtype`` is a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical across the 10 archs).
LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    # mlp
    mlp_type: str = "glu"        # "glu" (SwiGLU) | "gelu" (2-matmul)
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1           # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_period: int = 0         # hybrid: 1 attention layer per period (jamba: 8)
    # frontend
    frontend: Optional[str] = None   # None | "patch" | "frames" (stubbed embeds)
    # numerics / memory
    dtype: str = "bfloat16"
    remat: str = "full"          # "none" | "full" | "dots"
    train_microbatches: int = 1  # gradient-accumulation steps in the
                                 # production train step (activation memory
                                 # divider; global batch unchanged)
    # which shapes this arch runs; long_500k only for sub-quadratic attention
    supports_long_context: bool = False
    tie_embeddings: bool = False

    # -- derived ----------------------------------------------------------
    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return not self.is_ssm_only

    def moe_layer(self, layer_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer_idx % self.moe_every == self.moe_offset

    # -- parameter counting (for MODEL_FLOPS and memory budgeting) --------
    def _mlp_params(self, d_ff: int) -> int:
        if self.mlp_type == "glu":
            return 3 * self.d_model * d_ff
        return 2 * self.d_model * d_ff

    def _attn_params(self) -> int:
        return self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model

    def _ssm_params(self) -> int:
        di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * n + h)   # z, x, B, C, dt
        out_proj = di * self.d_model
        conv = self.ssm_conv_width * di
        other = h * 2 + di                              # A_log, dt_bias, D
        return in_proj + out_proj + conv + other

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count."""
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.d_model * self.vocab_size
        total = emb + head + 2 * self.d_model  # final norm (+eps slack)
        for i in range(self.n_layers):
            is_attn = self._layer_is_attention(i)
            if is_attn:
                total += self._attn_params()
            else:
                total += self._ssm_params()
            total += 2 * self.d_model  # per-layer norms
            if self.is_ssm_only:
                continue  # mamba blocks have no separate FFN
            if self.moe_layer(i):
                e = self.experts_per_token if active_only else self.n_experts
                total += e * self._mlp_params(self.d_ff)
                total += self.d_model * self.n_experts  # router (always dense)
            else:
                total += self._mlp_params(self.d_ff)
        return total

    def _layer_is_attention(self, i: int) -> bool:
        if self.is_ssm_only:
            return False
        if not self.is_hybrid:
            return True
        # hybrid: one attention layer per period, placed mid-period
        return (i % self.attn_period) == self.attn_period // 2

    def n_attn_layers(self) -> int:
        return sum(self._layer_is_attention(i) for i in range(self.n_layers))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "starcoder2_3b",
    "qwen2_5_32b",
    "h2o_danube_3_4b",
    "deepseek_coder_33b",
    "moonshot_v1_16b_a3b",
    "grok_1_314b",
    "musicgen_large",
    "internvl2_76b",
    "jamba_1_5_large",
    "mamba2_130m",
    # paper-native models
    "mnist_fc",
    "vgg16_cifar10",
)

_ALIASES = {
    "starcoder2-3b": "starcoder2_3b",
    "qwen2.5-32b": "qwen2_5_32b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "grok-1-314b": "grok_1_314b",
    "musicgen-large": "musicgen_large",
    "internvl2-76b": "internvl2_76b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "jamba-1.5-large": "jamba_1_5_large",
    "mamba2-130m": "mamba2_130m",
}


def canonical_arch(name: str) -> str:
    name = name.strip()
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_arch(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG


def shapes_for(cfg: ModelConfig) -> dict[str, ShapeSpec]:
    """The assigned shape cells this arch runs (long_500k gated)."""
    out = dict(LM_SHAPES)
    if not cfg.supports_long_context:
        out.pop("long_500k")
    return out
