"""Moonlight-16B-A3B [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128, mlp_type="glu",
    n_experts=64, experts_per_token=6,
    train_microbatches=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=96, vocab_size=512, n_experts=8, experts_per_token=2,
    capacity_factor=8.0, remat="none", dtype="float32")
