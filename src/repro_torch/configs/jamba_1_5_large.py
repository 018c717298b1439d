"""Jamba-1.5-Large-398B [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16e top-2 — Mamba+attention 1:7 interleave [arXiv:2403.19887; hf].
Sub-quadratic (Mamba carries the context; 9 attention layers) => runs
long_500k."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128, mlp_type="glu",
    n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    attn_period=8,
    supports_long_context=True,
    train_microbatches=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, attn_period=4, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, n_experts=4, experts_per_token=2,
    ssm_state=16, ssm_head_dim=16, capacity_factor=8.0, remat="none", dtype="float32")
