"""Phi-4-mini 3.8B.  [arXiv:2412.08905; hf]

Port of ``src/repro/configs/phi4_mini_3_8b.py``.
32L, d_model 3072, 24 heads (GQA kv=8), d_ff 8192, vocab 200064;
SwiGLU, RMSNorm, RoPE, tied embeddings.
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=200064,
        pattern=(("attn", "mlp"),),
        mlp_act="swiglu", norm="rmsnorm", rope_theta=10_000.0,
        tie_embeddings=True,
        ce_chunk=512, grad_accum=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke",
        family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True,
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
