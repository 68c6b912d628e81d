"""Whisper large-v3.  [arXiv:2212.04356; unverified]

Port of ``src/repro/configs/whisper_large_v3.py``.
Enc-dec: 32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA,
kv=20), d_ff 5120, vocab 51866, GELU, LayerNorm, learned positions.
The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, 1500, 1280].  1.53B parameters by
``param_count()`` (3.2 GB in bf16): the whole model serves and trains on
one 80 GB card.  ``encoder_ctx`` 1,500 is no multiple of the flash
kernels' 128-row tile, so the published ``attn_impl="xla"`` is the plan
that runs it (full attention: 1,500 is no multiple of ``attn_chunk``).
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866,
        pattern=(("attn", "mlp"),),
        mlp_act="gelu", norm="layernorm",
        tie_embeddings=True,
        encoder_layers=32, encoder_ctx=1500,
        frontend="audio",
        ce_chunk=512,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        mlp_act="gelu", norm="layernorm", tie_embeddings=True,
        encoder_layers=2, encoder_ctx=64,
        frontend="audio",
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
