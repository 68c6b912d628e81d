"""LLaVA-NeXT 34B (Yi/NH2 backbone).  [hf:llava-hf/llava-v1.6; unverified]

Port of ``src/repro/configs/llava_next_34b.py``.

60L, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000.
Anyres tiling frontend is a STUB per the assignment: input_specs() provides
1152 precomputed patch embeddings (base tile + 1 anyres tile) prefixed to
the token sequence; seq_len counts image+text tokens.  Full attention ->
long_500k skipped.
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_head=128, d_ff=20480, vocab=64000,
        pattern=(("attn", "mlp"),),
        mlp_act="swiglu", norm="rmsnorm", rope_theta=5_000_000.0,
        frontend="vision", frontend_tokens=1152,
        ce_chunk=512, grad_accum=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        pattern=(("attn", "mlp"),),
        mlp_act="swiglu", norm="rmsnorm",
        frontend="vision", frontend_tokens=16,
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
