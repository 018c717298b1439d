"""Mamba2-130M [ssm]: 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].
O(1) decode state => runs long_500k."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    supports_long_context=True, tie_embeddings=True,
    train_microbatches=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
    ssm_head_dim=16, remat="none", dtype="float32")
