"""Whisper-style encoder-decoder backbone (whisper-large-v3).

Port of ``src/repro/models/whisper.py`` on one device.  As there, the
conv/mel frontend is a stub: ``encode`` takes precomputed frame
embeddings [B, T_enc, D].  The backbone is the reference's: pre-LN
layernorm blocks, learned positions (no RoPE), bidirectional encoder
self-attention, causal decoder self-attention plus cross-attention to
the encoder output (``layers.attention(..., kv=enc_out)``), GELU MLPs,
the embedding tied to the output.  Parameters keep the reference's
layout, every layer's leaves stacked ``[n_layers, ...]``, so weights
carry across leaf for leaf (``parallel.sharding.lm_params_from_numpy``
builds from ``launch.steps.model_specs``, which is ``whisper_specs``
here); a Python loop over the layers takes the place of the reference's
``lax.scan`` / ``lax.map`` (and of its unrolled branch for two layers or
fewer, which computes the same).  Under autograd with ``cfg.remat`` each
layer runs in a non-reentrant ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``.

Serving: ``whisper_prefill`` encodes the audio once, computes every
layer's cross-attention K/V (decode-invariant), and primes the decoder's
self-attention caches; ``whisper_decode_step`` is one causal decoder
step.  Unlike the reference, which returns new caches, the decode step
writes the new self K/V into ``caches["self"]`` IN PLACE and returns the
same dict; ``caches["cross"]`` is read and never written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.sharding import ParamSpec
from .layers import (KVCache, QuantKVCache, _full_attention, apply_norm,
                     attention, attention_specs, decode_attention, mlp_apply,
                     mlp_specs, norm_spec, prefill_attention)
from .lm import _ce_full, _periods

__all__ = ["CrossCache", "whisper_specs", "encode", "decoder_forward",
           "whisper_loss", "whisper_prefill", "whisper_decode_step",
           "init_decoder_caches"]


class CrossCache(NamedTuple):
    k: torch.Tensor    # [n_layers, B, T_enc, K, dh]
    v: torch.Tensor


def whisper_specs(cfg) -> dict:
    D = cfg.d_model
    enc, dec = cfg.encoder_layers, cfg.n_layers
    return {
        "embed": ParamSpec((cfg.vocab, D), ("vocab", "embed"), "embed"),
        "enc_pos": ParamSpec((cfg.encoder_ctx, D), ("length", None), "embed"),
        "dec_pos": ParamSpec((32776, D), ("length", None), "embed"),
        "encoder": {
            "norm1": norm_spec(D, cfg.norm, (enc,)),
            "attn": attention_specs(cfg, (enc,)),
            "norm2": norm_spec(D, cfg.norm, (enc,)),
            "mlp": mlp_specs(D, cfg.d_ff, cfg.mlp_act, (enc,)),
        },
        "enc_final_norm": norm_spec(D, cfg.norm),
        "decoder": {
            "norm1": norm_spec(D, cfg.norm, (dec,)),
            "self_attn": attention_specs(cfg, (dec,)),
            "norm_x": norm_spec(D, cfg.norm, (dec,)),
            "cross_attn": attention_specs(cfg, (dec,), cross=True),
            "norm2": norm_spec(D, cfg.norm, (dec,)),
            "mlp": mlp_specs(D, cfg.d_ff, cfg.mlp_act, (dec,)),
        },
        "final_norm": norm_spec(D, cfg.norm),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _encoder_layer(p: dict, cfg, x, positions):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    x = x + attention(p["attn"], cfg, h, positions, causal=False,
                      use_rope=False)
    h = apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_act)


def _decoder_layer(p: dict, cfg, x, positions, enc_out):
    """One teacher-forced decoder layer: causal self-attention,
    cross-attention to ``enc_out``, then the MLP."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    x = x + attention(p["self_attn"], cfg, h, positions, causal=True,
                      use_rope=False)
    h = apply_norm(p["norm_x"], x, cfg.norm)
    x = x + attention(p["cross_attn"], cfg, h, positions, causal=False,
                      kv=enc_out, use_rope=False)
    h = apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_act)


def _run(layer, remat: bool, *args):
    if remat:
        return checkpoint(layer, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return layer(*args)


def encode(params: dict, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, T_enc, D] (stub frontend output) → encoder states."""
    B, T = frames.shape[0], frames.shape[1]
    x = frames.to(cfg.dtype) + params["enc_pos"][:T].to(cfg.dtype)
    positions = _positions(B, T, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _periods(params["encoder"], cfg.encoder_layers):
        x = _run(_encoder_layer, remat, p, cfg, x, positions)
    return apply_norm(params["enc_final_norm"], x, cfg.norm)


def _embed_tokens(params, cfg, tokens, start: int = 0):
    S = tokens.shape[1]
    return params["embed"][tokens].to(cfg.dtype) \
        + params["dec_pos"][start:start + S].to(cfg.dtype)


def decoder_forward(params: dict, cfg, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B,S] × enc_out [B,T,D] → hidden."""
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _periods(params["decoder"], cfg.n_layers):
        x = _run(_decoder_layer, remat, p, cfg, x, positions, enc_out)
    return apply_norm(params["final_norm"], x, cfg.norm)


def whisper_loss(params: dict, cfg, frames: torch.Tensor,
                 tokens: torch.Tensor, labels: torch.Tensor):
    """Enc-dec training loss (teacher forcing, CE over decoder positions;
    labels < 0 masked).  The logits are an fp32 product of the
    model-dtype hidden states and embedding, the reference's
    ``preferred_element_type=float32``.  Returns (ce, {"ce": ce})."""
    enc_out = encode(params, cfg, frames)
    hidden = decoder_forward(params, cfg, tokens, enc_out)
    h, y = hidden[:, :-1], labels[:, 1:]
    mask = (y >= 0).float()
    nll, cnt = _ce_full(h, params["embed"].T, torch.clamp(y, min=0), mask)
    ce = nll / torch.clamp(cnt, min=1.0)
    return ce, {"ce": ce}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_decoder_caches(cfg, batch: int, t_max: int, device=None):
    """Zeroed caches: ``{"self": KVCache [L, B, t_max, K·dh], "cross":
    KVCache [L, B, encoder_ctx, K·dh]}`` in ``cfg.dtype`` on ``device``
    (default: the card); with ``cfg.kv_cache_quant`` both are the
    reference's int8 ``QuantKVCache`` (fp32 scales [L, B, t, K])."""
    device = resolve_device(device)
    L, kd = cfg.n_layers, cfg.n_kv_heads * cfg.head_dim

    def kv(t):
        if cfg.kv_cache_quant:
            return QuantKVCache.zeros((L, batch, t, kd), cfg.n_kv_heads,
                                      device)
        return KVCache(
            k=torch.zeros((L, batch, t, kd), dtype=cfg.dtype, device=device),
            v=torch.zeros((L, batch, t, kd), dtype=cfg.dtype, device=device))

    return {"self": kv(t_max), "cross": kv(cfg.encoder_ctx)}


def whisper_prefill(params: dict, cfg, frames: torch.Tensor,
                    prompt: torch.Tensor, t_max: int):
    """Encode audio, precompute cross K/V, prime decoder self caches.

    prompt: [B, S0] decoder prompt tokens.  Returns (logits [B, V] at the
    last prompt position, caches, pos = S0); the self caches are padded to
    ``t_max`` (never cut below S0), the cross caches hold every layer's
    ``enc_out @ wk`` / ``@ wv`` flattened [L, B, T_enc, K·dh]."""
    enc_out = encode(params, cfg, frames)
    B, T = enc_out.shape[0], enc_out.shape[1]
    L, H, K, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kd = K * dh
    layers_p = _periods(params["decoder"], L)
    cross = KVCache(
        k=torch.empty((L, B, T, kd), dtype=enc_out.dtype,
                      device=enc_out.device),
        v=torch.empty((L, B, T, kd), dtype=enc_out.dtype,
                      device=enc_out.device))
    for l, p in enumerate(layers_p):
        cross.k[l] = enc_out @ p["cross_attn"]["wk"]
        cross.v[l] = enc_out @ p["cross_attn"]["wv"]

    S0 = prompt.shape[1]
    x = _embed_tokens(params, cfg, prompt)
    positions = _positions(B, S0, x.device)
    size = (L, B, max(t_max, S0), kd)
    self_cache = KVCache(k=torch.zeros(size, dtype=x.dtype, device=x.device),
                         v=torch.zeros(size, dtype=x.dtype, device=x.device))
    for l, p in enumerate(layers_p):
        h = apply_norm(p["norm1"], x, cfg.norm)
        att, made = prefill_attention(p["self_attn"], cfg, h, positions,
                                      use_rope=False)
        self_cache.k[l, :, :S0] = made.k
        self_cache.v[l, :, :S0] = made.v
        x = x + att
        # cross attention against the precomputed encoder K/V
        h = apply_norm(p["norm_x"], x, cfg.norm)
        q = (h @ p["cross_attn"]["wq"]).reshape(B, S0, H, dh)
        out = _full_attention(q, cross.k[l].reshape(B, T, K, dh),
                              cross.v[l].reshape(B, T, K, dh), causal=False)
        x = x + out.reshape(B, S0, H * dh) @ p["cross_attn"]["wo"]
        h = apply_norm(p["norm2"], x, cfg.norm)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_act)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = x[:, -1] @ params["embed"].T
    return logits, {"self": self_cache, "cross": cross}, S0


def whisper_decode_step(params: dict, cfg, caches: dict, token: torch.Tensor,
                        pos):
    """One decoder step.  token [B,1] at position ``pos`` (an int);
    returns (logits [B,V], caches).  The new self K/V are written into
    ``caches["self"]`` at ``pos`` IN PLACE; ``caches["cross"]`` is read
    over all its positions and left as it was; the same dict is
    returned."""
    pos = int(pos)
    L = cfg.n_layers
    x = _embed_tokens(params, cfg, token, pos)
    t_enc = caches["cross"].k.shape[2]
    self_c = _periods(caches["self"], L)
    cross_c = _periods(caches["cross"], L)
    for l, p in enumerate(_periods(params["decoder"], L)):
        h = apply_norm(p["norm1"], x, cfg.norm)
        att, _ = decode_attention(p["self_attn"], cfg, h, self_c[l], pos,
                                  use_rope=False)
        x = x + att
        h = apply_norm(p["norm_x"], x, cfg.norm)
        att, _ = decode_attention(p["cross_attn"], cfg, h, cross_c[l],
                                  t_enc - 1, update_cache=False,
                                  use_rope=False)
        x = x + att
        h = apply_norm(p["norm2"], x, cfg.norm)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_act)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = x[:, 0] @ params["embed"].T
    return logits, caches
