"""Modality frontend stubs of the audio (musicgen) and vision-language
(internvl2) architectures, as the reference's ``models/frontends.py``.

These architectures specify the transformer backbone only: the EnCodec
tokenizer (musicgen) and the InternViT patch tower (internvl2) are stubs
whose role is the shape contract, precomputed frame or patch embeddings of
shape (batch, seq, d_model) that ``models.transformer`` takes in place of
tokens. The functions draw such embeddings, 0.02 x ``core.prng.normal``,
the twin of the reference's ``jax.random.normal`` at the same key. They
draw on the host and then move to ``device``, so the card and the CPU get
the same embeddings; after the cast to bf16 they equal the reference's
(``prng.normal`` differs from it by a few f32 ulps in ~1% of the values,
below bf16's rounding).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng


def _stub(key: prng.Key, batch: int, seq: int, d_model: int, dtype, device) -> torch.Tensor:
    x = prng.normal(key, (batch, seq, d_model)) * 0.02
    return x.to(device=device, dtype=dtype)


def frame_embeddings(key: prng.Key, batch: int, seq: int, d_model: int,
                     dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Stub EnCodec frame embeddings (musicgen)."""
    return _stub(key, batch, seq, d_model, dtype, device)


def patch_embeddings(key: prng.Key, batch: int, seq: int, d_model: int,
                     dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Stub InternViT patch embeddings (internvl2)."""
    return _stub(key, batch, seq, d_model, dtype, device)


STUBS = {"frames": frame_embeddings, "patch": patch_embeddings}
