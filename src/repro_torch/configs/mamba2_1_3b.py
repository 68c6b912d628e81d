"""Mamba-2 1.3B.  [arXiv:2405.21060; unverified]

Port of ``src/repro/configs/mamba2_1_3b.py``.
48L, d_model 2048, attention-free (SSD), ssm_state 128, headdim 64,
expand 2, vocab 50280, tied embeddings.
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=0, vocab=50280,
        pattern=(("mamba", "none"),),
        norm="rmsnorm", tie_embeddings=True,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ce_chunk=512, grad_accum=2,
        notes="SSD chunked scan; vocab 50280 is not 16-divisible — GSPMD "
              "pads the vocab shard (see DESIGN).",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=512,
        pattern=(("mamba", "none"),),
        norm="rmsnorm", tie_embeddings=True,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
        remat=False, dtype=torch.float32,
    )
