"""StarCoder2-3B [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    mlp_type="gelu",  # starcoder2 uses a 2-matmul GELU MLP (d_ff = 4*d)
    train_microbatches=2,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, remat="none", dtype="float32")
