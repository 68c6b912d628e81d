"""Llama-4 Scout 17B-active/16-expert (109B total).

Port of ``src/repro/configs/llama4_scout_17b_a16e.py``.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L, d_model 5120, 40 heads (GQA kv=8), d_ff 8192, vocab 202048;
MoE: 16 routed experts, top-1, plus a Llama-4 always-on shared expert.
Assigned config uses plain GQA (no chunked-attention long-ctx variant), so
``long_500k`` is skipped (full attention).
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048,
        pattern=(("attn", "moe"),),
        mlp_act="swiglu", norm="rmsnorm", rope_theta=500_000.0,
        n_experts=16, top_k=1, d_ff_moe=8192, shared_expert=True,
        ce_chunk=512, grad_accum=8,
        notes="MoE top-1 + shared expert; early-fusion frontends not in "
              "scope of the LM backbone shapes.",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        pattern=(("attn", "moe"),),
        mlp_act="swiglu", norm="rmsnorm",
        n_experts=4, top_k=1, d_ff_moe=128, shared_expert=True, capacity_factor=8.0,
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
