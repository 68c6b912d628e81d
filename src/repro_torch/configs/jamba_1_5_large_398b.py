"""Jamba-1.5 Large (398B total / 94B active).  [arXiv:2403.19887; hf]

Port of ``src/repro/configs/jamba_1_5_large_398b.py``.

72L, d_model 8192; hybrid period-8 blocks: 1 attention layer (64H, GQA
kv=8) per 7 mamba layers; MoE (16 experts, top-2, d_ff 24576) on every
other layer.  Sub-quadratic (mamba state + 9 attention layers) -> runs
long_500k with the attention KV sharded over `data` (sequence parallel).

Adaptation note: Jamba ships Mamba-1 layers; we use the Mamba-2/SSD form
(scalar-decay — the TPU-native chunked-matmul formulation).  Recorded in
DESIGN.md §Arch-applicability.
"""

import torch

from ..models.config import ModelConfig

_PERIOD = (
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("attn", "moe"),
    ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_head=128, d_ff=24576, vocab=65536,
        pattern=_PERIOD,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=10_000.0,
        n_experts=16, top_k=2, d_ff_moe=24576,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ce_chunk=512, grad_accum=32, optimizer="adafactor",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        pattern=tuple(_PERIOD),
        mlp_act="swiglu", norm="rmsnorm",
        n_experts=4, top_k=2, d_ff_moe=128, capacity_factor=8.0,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
        attn_chunk=64, remat=False, dtype=torch.float32,
    )
