"""Grok-1-314B [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 [hf:xai-org/grok-1; unverified]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128, mlp_type="gelu",
    n_experts=8, experts_per_token=2,
    train_microbatches=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, n_experts=4, experts_per_token=2,
    capacity_factor=8.0, remat="none", dtype="float32")
