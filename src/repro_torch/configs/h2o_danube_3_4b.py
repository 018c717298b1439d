"""H2O-Danube-3-4B [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; unverified]. SWA makes decode O(window) => runs
long_500k."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000, head_dim=120,
    sliding_window=4096, mlp_type="glu",
    supports_long_context=True,
    train_microbatches=2,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=384, vocab_size=512, sliding_window=64, remat="none", dtype="float32")
