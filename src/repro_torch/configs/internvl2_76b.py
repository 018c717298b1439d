"""InternVL2-76B [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + LLM backbone [arXiv:2404.16821; unverified].
The ViT tower is a stub: input_specs feeds precomputed patch embeddings."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128, mlp_type="glu",
    frontend="patch",
    train_microbatches=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=512, remat="none", dtype="float32")
