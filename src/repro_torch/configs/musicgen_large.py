"""MusicGen-Large [audio]: 48L d_model=2048 32H (kv=32 => MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
Frontend (EnCodec) is a stub: input_specs feeds precomputed frame embeddings."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64, mlp_type="gelu",
    frontend="frames",
    train_microbatches=2,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=128, remat="none", dtype="float32")
