"""Generic decoder LM over a repeating block pattern.

Port of ``src/repro/models/lm.py`` on one device.  One code path covers
dense GQA (Phi-4-mini, StarCoder2, the LLaVA backbone), MoE (Qwen3-MoE,
Llama-4 Scout), pure SSM (Mamba-2) and the Jamba hybrid: the pattern
(tuple of (mixer, ffn) pairs) is data, not code.  Parameters keep the
reference's layout, stacked ``[n_periods, ...]`` per pattern position, so
weights carry across leaf for leaf
(``parallel.sharding.lm_params_from_numpy``); where the reference scans
over periods, a Python loop walks them.

Entry points:
  forward      — forward to final hidden states (+ the MoE aux term,
                 summed over the MoE blocks; 0 without them), each
                 period rematerialized in the backward when ``cfg.remat``
                 (``torch.utils.checkpoint``, non-reentrant: the
                 reference's ``jax.checkpoint`` policy ``"full"``)
  lm_logits    — hidden states → logits
  lm_loss      — causal cross-entropy, full or chunked over the sequence
  prefill      — forward + per-layer KV/Mamba caches for serving
  decode_step  — one-token serve step against the caches (IN PLACE)
  init_caches  — zeroed caches for the continuous-batching loop

Multimodal prefix (the LLaVA stub): ``extra_embeds`` [B, P, D] is cast
to ``cfg.dtype`` and concatenated in front of the token embeddings;
positions run over the whole sequence, and ``prefill`` returns its length
as ``next_pos``.  The ``"dots"`` remat policy is ``ROADMAP.md`` A7.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from . import moe as moe_mod
from . import ssd as ssd_mod
from .layers import (KVCache, apply_norm, attention, attention_specs,
                     ct_cast, decode_attention, embed_specs, mlp_apply,
                     mlp_specs, norm_spec, prefill_attention)

__all__ = ["lm_specs", "forward", "lm_logits", "lm_loss", "prefill",
           "decode_step", "init_caches"]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _block_specs(cfg, mixer: str, ffn: str) -> dict:
    stacked = (cfg.n_periods,)
    p: dict[str, Any] = {"norm1": norm_spec(cfg.d_model, cfg.norm, stacked)}
    if mixer == "attn":
        p["attn"] = attention_specs(cfg, stacked)
    elif mixer == "mamba":
        p["mamba"] = ssd_mod.ssd_specs(cfg, stacked)
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn != "none":
        p["norm2"] = norm_spec(cfg.d_model, cfg.norm, stacked)
    if ffn == "mlp":
        p["ffn"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_act, stacked)
    elif ffn == "moe":
        p["ffn"] = moe_mod.moe_specs(cfg, stacked)
    return p


def lm_specs(cfg) -> dict:
    return {
        **embed_specs(cfg),
        "blocks": [_block_specs(cfg, m, f) for m, f in cfg.pattern],
        "final_norm": norm_spec(cfg.d_model, cfg.norm),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_block(cfg, mixer: str, ffn: str, p: dict, x, positions,
                 mode: str = "full", cache=None, pos=None):
    """One block.  Returns (x, new_cache, aux)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    new_cache = None
    if mixer == "attn":
        if mode == "full":
            att = attention(p["attn"], cfg, h, positions, causal=True)
        elif mode == "prefill":
            att, new_cache = prefill_attention(p["attn"], cfg, h, positions)
        else:  # decode
            att, new_cache = decode_attention(p["attn"], cfg, h, cache, pos)
    else:  # mamba
        if mode == "full":
            att = ssd_mod.ssd_apply(p["mamba"], cfg, h)
        elif mode == "prefill":
            att, new_cache = ssd_mod.ssd_apply(p["mamba"], cfg, h,
                                               return_cache=True)
        else:
            att, new_cache = ssd_mod.ssd_decode(p["mamba"], cfg, h, cache)
    x = x + att
    aux = None
    if ffn != "none":
        h2 = apply_norm(p["norm2"], x, cfg.norm)
        if ffn == "mlp":
            y = mlp_apply(p["ffn"], h2, cfg.mlp_act)
        else:
            y, aux = moe_mod.moe_apply(p["ffn"], cfg, h2)
        x = x + y
    return x, new_cache, aux


def _embed(params, cfg, tokens, extra_embeds=None):
    x = params["embed"][tokens].to(cfg.dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cfg.dtype), x], dim=1)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _periods(tree, n: int) -> list:
    """The stacked leaves of ``tree`` as ``n`` per-period trees, with one
    ``unbind(0)`` per leaf.  Under autograd, ``a[p]`` for each period
    would give each period's backward a zero tensor of the whole stacked
    leaf; ``unbind``'s backward stacks the period gradients once."""
    parts = [a.unbind(0) for a in tree_leaves(tree)]
    out = []
    for p in range(n):
        leaf = iter(parts)
        out.append(tree_map(lambda _: next(leaf)[p], tree))
    return out


def _unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params: dict, cfg, tokens: torch.Tensor,
            extra_embeds: torch.Tensor | None = None):
    """tokens [B,S] (+ prefix embeds [B,P,D]) → (hidden [B,P+S,D], aux).
    ``aux`` is the reference's MoE auxiliary loss summed over the blocks
    (fp32): 0 for the dense and SSM patterns.

    Under autograd with ``cfg.remat``, each period runs inside a
    non-reentrant checkpoint: only its input is kept, and the backward
    runs the period's forward again (so the flash kernel launches twice
    per layer and step).  ``cfg.bf16_grads`` puts ``ct_cast`` at each
    period's input, as the reference does."""
    x, positions = _embed(params, cfg, tokens, extra_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def inner(x, block_params):
        a = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.bf16_grads:
            x = ct_cast(x)
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            x, _, ai = _apply_block(cfg, mixer, ffn, block_params[i], x,
                                    positions)
            if ai is not None:
                a = a + ai
        return x, a

    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy == "dots":
        raise NotImplementedError("the 'dots' remat policy (save the "
                                  "matmul outputs) is ROADMAP.md A7")
    for block_params in _periods(params["blocks"], cfg.n_periods):
        if remat:
            x, a = checkpoint(inner, x, block_params, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = inner(x, block_params)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux


def lm_logits(params: dict, cfg, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ _unembed_matrix(params, cfg)


def _ce_full(hidden, w, labels, mask, fp32_gemm: bool = True):
    """Summed cross entropy and token count.  ``fp32_gemm`` computes the
    logits from the model-dtype operands with an fp32 product (the
    reference's ``preferred_element_type=float32``: bf16 values are exact
    in fp32, so only the summation order differs); otherwise the GEMM
    runs in the model dtype and its output is upcast."""
    if fp32_gemm:
        logits = hidden.float() @ w.float()
    else:
        logits = (hidden @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def _ce_chunked(hidden, w, labels, mask, chunk: int, fp32_gemm: bool = True):
    """Never materializes [B,S,V]: a loop over sequence chunks.  Falls
    back to ``_ce_full`` when the chunk does not divide S, as the
    reference does (``lm.py:210-211``)."""
    S = hidden.shape[1]
    if S % chunk:
        return _ce_full(hidden, w, labels, mask, fp32_gemm)
    if fp32_gemm:
        w = w.float()       # cast once: every chunk's backward shares it
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        n, c = _ce_full(hidden[:, sl], w, labels[:, sl], mask[:, sl],
                        fp32_gemm)
        nll = nll + n
        cnt = cnt + c
    return nll, cnt


def lm_loss(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor,
            extra_embeds: torch.Tensor | None = None):
    """Causal LM loss.  labels [B,S_total] aligned to the *full* sequence
    (prefix positions < 0 are masked).  Returns (loss, {"ce", "aux",
    "tokens"})."""
    hidden, aux = forward(params, cfg, tokens, extra_embeds)
    w = _unembed_matrix(params, cfg)
    # predict token t+1 from hidden t
    h = hidden[:, :-1]
    y = labels[:, 1:]
    mask = (y >= 0).float()
    y = torch.clamp(y, min=0)
    if cfg.ce_chunk:
        nll, cnt = _ce_chunked(h, w, y, mask, cfg.ce_chunk, cfg.ce_fp32)
    else:
        nll, cnt = _ce_full(h, w, y, mask, cfg.ce_fp32)
    ce = nll / torch.clamp(cnt, min=1.0)
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, t_max: int, device=None):
    """Zeroed caches: one entry per pattern position, leaves stacked over
    periods.  Attention: ``KVCache`` [n_periods, B, t_max, K·dh] in
    ``cfg.dtype``; mamba: ``MambaCache``.  ``device`` defaults to the
    card (``resolve_device``)."""
    if cfg.kv_cache_quant:
        raise NotImplementedError("the int8 KV cache (kv_cache_quant) is "
                                  "ROADMAP.md A7")
    device = resolve_device(device)
    n = cfg.n_periods
    caches = []
    for mixer, _ in cfg.pattern:
        if mixer == "attn":
            shape = (n, batch, t_max, cfg.n_kv_heads * cfg.head_dim)
            caches.append(KVCache(
                k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                v=torch.zeros(shape, dtype=cfg.dtype, device=device)))
        else:
            c = ssd_mod.init_mamba_cache(cfg, batch, cfg.dtype, device)
            caches.append(tree_map(
                lambda a: a[None].repeat(n, *([1] * a.dim())), c))
    return caches


def prefill(params: dict, cfg, tokens: torch.Tensor,
            extra_embeds: torch.Tensor | None = None,
            t_max: int | None = None):
    """Process the prompt (after the prefix embeds [B,P,D], if any);
    returns (last-position logits, caches, next_pos = P + S).

    ``t_max`` pads attention KV caches to a serving budget (default: the
    sequence length).
    """
    x, positions = _embed(params, cfg, tokens, extra_embeds)
    B, S = x.shape[0], x.shape[1]
    per_period = []
    for block_params in _periods(params["blocks"], cfg.n_periods):
        made = []
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            x, cache, _ = _apply_block(cfg, mixer, ffn, block_params[i],
                                       x, positions, mode="prefill")
            made.append(cache)
        per_period.append(made)
    caches = []
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn":
            # written straight into the padded buffer (no stacked copy)
            shape = (cfg.n_periods, B, max(t_max or S, S),
                     cfg.n_kv_heads * cfg.head_dim)
            kv = KVCache(k=torch.zeros(shape, dtype=x.dtype, device=x.device),
                         v=torch.zeros(shape, dtype=x.dtype, device=x.device))
            for period, made in enumerate(per_period):
                kv.k[period, :, :S] = made[i].k
                kv.v[period, :, :S] = made[i].v
            caches.append(kv)
        else:
            caches.append(tree_map(lambda *xs: torch.stack(xs),
                                   *[made[i] for made in per_period]))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = x[:, -1] @ _unembed_matrix(params, cfg)
    return logits, caches, S


def decode_step(params: dict, cfg, caches, token: torch.Tensor, pos):
    """One serve step: token [B,1] at position ``pos`` (an int).

    Returns (logits [B,V], caches).  The caches are updated IN PLACE —
    the new K/V are written at ``pos`` and the mamba conv tails and states
    replaced — and the same list is returned (the reference returns new
    caches; copying them each step would move every layer's cache).
    """
    x = params["embed"][token].to(cfg.dtype)
    cache_periods = [_periods(c, cfg.n_periods) for c in caches]
    for period, block_params in enumerate(
            _periods(params["blocks"], cfg.n_periods)):
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            cache = cache_periods[i][period]
            x, new, _ = _apply_block(cfg, mixer, ffn, block_params[i], x,
                                     None, mode="decode", cache=cache,
                                     pos=pos)
            if mixer == "mamba":
                for view, fresh in zip(cache, new):
                    view.copy_(fresh)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = x[:, 0] @ _unembed_matrix(params, cfg)
    return logits, caches
