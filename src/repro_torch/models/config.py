"""ModelConfig: one dataclass describing every assigned architecture.

Port of ``src/repro/models/config.py``.  A model is a stack of
``n_layers`` blocks following a repeating ``pattern`` of (mixer, ffn)
pairs — e.g. dense GQA = ``(("attn","mlp"),)``, Qwen3-MoE =
``(("attn","moe"),)``, Mamba-2 = ``(("mamba","none"),)``, Jamba's period-8
hybrid = 7 mamba + 1 attention with MoE every other layer.  The fields
are the reference's, so a config carries across field for field;
``dtype`` is a ``torch.dtype``.  The port runs every family, the
encoder-decoder Whisper included, with the single-device levers
(``kv_cache_quant``, ``remat_policy="dots"``); the mesh lever
``pad_heads`` is kept so configs stay comparable, and the attention
that would read it raises (``ROADMAP.md`` A7.5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None          # default d_model // n_heads
    # block pattern: tuple of (mixer, ffn); mixer in {attn, mamba};
    # ffn in {mlp, moe, none}; len(pattern) must divide n_layers
    pattern: tuple[tuple[str, str], ...] = (("attn", "mlp"),)
    mlp_act: str = "swiglu"            # swiglu | gelu | squared_relu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 1
    d_ff_moe: int | None = None        # expert hidden dim (defaults to d_ff)
    shared_expert: bool = False        # Llama-4 style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_ctx: int = 1500            # audio frame positions
    # modality frontend stub: None | "audio" | "vision"
    frontend: str | None = None
    frontend_tokens: int = 0           # vision: image-patch prefix length
    # training / numerics
    dtype: Any = torch.bfloat16
    ce_chunk: int = 0                  # 0 = full-logits CE; else chunked
    attn_chunk: int = 512              # q/kv chunking for long sequences
    remat: bool = True
    optimizer: str = "adamw"           # adamw | adafactor (giant archs)
    grad_accum: int = 1                # microbatches per step
    # ---- perf levers (defaults = paper-faithful baseline)
    ce_fp32: bool = True
    bf16_grads: bool = False
    remat_policy: str = "full"         # full | dots | none
    pad_heads: bool = False            # TP head padding (ROADMAP A7.5)
    attn_impl: str = "xla"             # "flash": the hand-written kernels
    #                                    on CUDA, mha_ref on the CPU;
    #                                    "flash_interpret": the kernels'
    #                                    autograd Function, on the CPU
    #                                    over their plain versions
    ssd_impl: str = "xla"              # "kernel": intra-chunk SSD kernel
    #                                    ("kernel_interpret" its alias)
    kv_cache_quant: bool = False       # int8 KV cache (init_caches)
    moe_ep: bool = True
    serve_replicate_params: bool = False
    serve_2d_tp: bool = False
    # metadata
    family: str = "dense"              # dense|moe|ssm|hybrid|audio|vlm
    notes: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(m != "attn" for m, _ in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context?  (SSM/hybrid: the
        mamba state is O(1) and the few attention layers are decode-linear.)"""
        return any(m == "mamba" for m, _ in self.pattern)

    def param_count(self) -> int:
        """Total parameters (analytic)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        dh = self.head_dim
        total = V * D                                     # embedding
        if not self.tie_embeddings:
            total += V * D                                # unembedding
        per_pattern = 0
        for mixer, ffn in self.pattern:
            per_pattern += D                              # pre-mixer norm
            if mixer == "attn":
                per_pattern += D * self.n_heads * dh      # q
                per_pattern += 2 * D * self.n_kv_heads * dh   # k,v
                per_pattern += self.n_heads * dh * D      # o
            elif mixer == "mamba":
                di, N, H = self.ssm_inner, self.ssm_state, self.ssm_heads
                conv_ch = di + 2 * N
                per_pattern += D * (2 * di + 2 * N + H)   # in_proj
                per_pattern += conv_ch * self.ssm_conv    # conv1d
                per_pattern += 3 * H + di                 # A, D, dt_bias, gnorm
                per_pattern += di * D                     # out_proj
            if ffn != "none":
                per_pattern += D                          # pre-ffn norm
            if ffn == "mlp":
                mult = 3 if self.mlp_act == "swiglu" else 2
                per_pattern += mult * D * F
            elif ffn == "moe":
                Fm = self.d_ff_moe or F
                mult = 3 if self.mlp_act == "swiglu" else 2
                per_pattern += self.n_experts * mult * D * Fm
                per_pattern += D * self.n_experts         # router
                if self.shared_expert:
                    per_pattern += mult * D * Fm
        total += per_pattern * self.n_periods
        total += D                                        # final norm
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.encoder_layers * (
                2 * D + D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh
                + self.n_heads * dh * D
                + (3 if self.mlp_act == "swiglu" else 2) * D * F)
            cross = self.n_layers * (
                D + D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh
                + self.n_heads * dh * D)
            total += enc + cross + D
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        Fm = self.d_ff_moe or self.d_ff
        mult = 3 if self.mlp_act == "swiglu" else 2
        moe_layers = sum(1 for _, f in self.pattern if f == "moe") \
            * self.n_periods
        inactive = (self.n_experts - self.top_k) * mult * self.d_model * Fm
        return int(self.param_count() - moe_layers * inactive)
