"""DeepSeek-Coder-33B [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch [arXiv:2401.14196; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256, head_dim=128, mlp_type="glu",
    train_microbatches=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=512, remat="none", dtype="float32")
