"""Qwen3-MoE 235B-A22B.  [hf:Qwen/Qwen3-30B-A3B family; hf]

Port of ``src/repro/configs/qwen3_moe_235b_a22b.py``.

94L, d_model 4096, 64 heads (GQA kv=4), expert d_ff 1536, vocab 151936;
128 experts, top-8, QK-norm (Qwen3).  Full attention -> long_500k skipped.
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_head=128, d_ff=1536, vocab=151936,
        pattern=(("attn", "moe"),),
        mlp_act="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
        qk_norm=True,
        n_experts=128, top_k=8, d_ff_moe=1536,
        ce_chunk=512, grad_accum=8, optimizer="adafactor",
        notes="128-expert top-8 EP over the model axis.",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512,
        pattern=(("attn", "moe"),),
        mlp_act="swiglu", norm="rmsnorm", qk_norm=True,
        n_experts=8, top_k=2, d_ff_moe=96, capacity_factor=8.0,
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
