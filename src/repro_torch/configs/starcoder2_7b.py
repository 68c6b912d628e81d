"""StarCoder2-7B.  [arXiv:2402.19173; hf]

Port of ``src/repro/configs/starcoder2_7b.py``.

32L, d_model 4608, 36 heads (GQA kv=4), d_ff 18432, vocab 49152;
GELU MLP, LayerNorm, RoPE (sliding-window attention of the release is not
part of the assigned config).  Full attention -> long_500k skipped.
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_head=128, d_ff=18432, vocab=49152,
        pattern=(("attn", "mlp"),),
        mlp_act="gelu", norm="layernorm", rope_theta=100_000.0,
        ce_chunk=512, grad_accum=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        pattern=(("attn", "mlp"),),
        mlp_act="gelu", norm="layernorm",
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
