"""Nemotron-4 340B.  [arXiv:2402.16819; unverified]

Port of ``src/repro/configs/nemotron_4_340b.py``.
96L, d_model 18432, 96 heads (GQA kv=8) of 192, d_ff 73728, vocab 256000;
squared-ReLU MLP (no gate), LayerNorm, RoPE, untied embeddings; trained
with Adafactor (factored second moments).  One layer with the embedding
and unembedding is 12.89B parameters (25.8 GB in bf16): on one 80 GB
card the full 96 layers neither serve nor train, so the card's runs cut
the depth (``chip_smoke.py``).
"""

import torch

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
        d_head=192, d_ff=73728, vocab=256000,
        pattern=(("attn", "mlp"),),
        mlp_act="squared_relu", norm="layernorm", rope_theta=10_000.0,
        ce_chunk=512, grad_accum=64, optimizer="adafactor",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-smoke",
        family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab=512,
        pattern=(("attn", "mlp"),),
        mlp_act="squared_relu", norm="layernorm",
        attn_chunk=64, remat=False, dtype=torch.float32, optimizer="adafactor",
    )
