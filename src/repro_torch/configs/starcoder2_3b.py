"""StarCoder2-3B.  [arXiv:2402.19173; hf]

Port of ``src/repro/configs/starcoder2_3b.py``.

30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152;
GELU, LayerNorm, RoPE.  Full attention -> long_500k skipped.
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152,
        pattern=(("attn", "mlp"),),
        mlp_act="gelu", norm="layernorm", rope_theta=100_000.0,
        ce_chunk=512, grad_accum=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=512,
        pattern=(("attn", "mlp"),),
        mlp_act="gelu", norm="layernorm",
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
