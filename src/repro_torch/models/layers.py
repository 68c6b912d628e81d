"""Shared neural layers: norms, RoPE, GQA attention (train/prefill/decode),
dense MLP variants, embeddings.

Port of ``src/repro/models/layers.py`` for one device: the reference's
``shard``/``shard_fit`` annotations have no counterpart here and are
dropped.  Attention offers the reference's plans, chosen by
``cfg.attn_impl`` exactly as ``_attention_core`` does there:

* ``"flash"`` → ``kernels.attention.mha``: the hand-written kernels on
  CUDA (forward, and dq and dk/dv under autograd), ``mha_ref`` on the
  CPU; ``"flash_interpret"`` passes ``mode="interpret"``, as the
  reference does: the kernels on CUDA, on the CPU the same autograd
  Function over the kernels' plain versions;
* ``"xla"`` → ``chunked`` (streaming softmax over q/kv blocks, for
  ``S > attn_chunk`` divisible by it) or ``full`` (scores materialized).

Cross-attention (Whisper) is ``attention(..., kv=enc_out)``: q from x,
k and v from ``kv``, through the same plan, so a flash config sends
decoder queries (S) against encoder keys (T != S) through the kernels.

Decode attends one query against a fixed-capacity cache with a length
mask and writes the new K/V into the cache IN PLACE; with
``update_cache=False`` (Whisper's precomputed cross K/V) it writes
nothing.  The cache is a ``KVCache`` in the model dtype or the
reference's int8 ``QuantKVCache`` (per-(token, kv-head) fp32 scales,
``_quantize_kv``), dequantized to the model dtype before the products.
Softmax statistics accumulate in fp32, as in the reference (its
``preferred_element_type=float32`` dots are fp32 products here).

``ct_cast`` is the reference's cotangent cast (identity forward; the
cotangent cast to the input's dtype on the way back), as an autograd
Function.  Torch's autograd already casts every cotangent to its
tensor's dtype, so in the port it pins what the reference has to pin by
hand, and changes no number.

Not ported (``ROADMAP.md``): the TP head padding ``_maybe_pad_heads``
(``cfg.pad_heads``, A7.5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import ParamSpec

__all__ = ["ct_cast", "rmsnorm", "layernorm", "norm_spec", "apply_norm",
           "rope",
           "attention_specs", "attention", "prefill_attention",
           "decode_attention", "KVCache", "QuantKVCache", "mlp_specs",
           "mlp_apply",
           "embed_specs"]

NEG_INF = -1e30


class _CtCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype)


def ct_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts the COTANGENT to x's dtype on the way back
    (``src/repro/models/layers.py:32-55``, the ``bf16_grads`` lever)."""
    return _CtCast.apply(x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_spec(d: int, kind: str, stacked: tuple[int, ...] = ()) -> dict:
    axes = ("layers",) * len(stacked)
    p = {"scale": ParamSpec(stacked + (d,), axes + (None,), "ones")}
    if kind == "layernorm":
        p["bias"] = ParamSpec(stacked + (d,), axes + (None,), "zeros")
    return p


def rmsnorm(x, scale, eps=1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def layernorm(x, scale, bias, eps=1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def apply_norm(params: dict, x, kind: str):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B,S,H,dh]; positions: [B,S] (int).  Rotates pairs (i, i+dh/2)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor     # [B, T, K·dh] (flattened; see attention_specs)
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """The reference's int8 KV cache: each (token, kv head) row of dh
    values stored as int8 with one fp32 scale."""
    k: torch.Tensor         # int8 [B, T, K·dh]
    v: torch.Tensor
    k_scale: torch.Tensor   # fp32 [B, T, K]
    v_scale: torch.Tensor

    @classmethod
    def zeros(cls, shape: tuple, n_kv_heads: int, device) -> "QuantKVCache":
        """A zeroed cache: k, v of ``shape`` (``[..., T, K·dh]``), their
        scales of ``shape[:-1] + (K,)``."""
        sshape = tuple(shape[:-1]) + (n_kv_heads,)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device))


def attention_specs(cfg, stacked: tuple[int, ...] = (), cross: bool = False
                    ) -> dict:
    """Projection weights stored with FLATTENED head dims ([D, H·dh]), as
    the reference stores them.  ``cross`` (cross-attention) changes
    nothing, as in the reference."""
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lay = ("layers",) * len(stacked)
    p = {
        "wq": ParamSpec(stacked + (D, H * dh), lay + ("embed", "heads")),
        "wk": ParamSpec(stacked + (D, K * dh), lay + ("embed", "kv_heads")),
        "wv": ParamSpec(stacked + (D, K * dh), lay + ("embed", "kv_heads")),
        "wo": ParamSpec(stacked + (H * dh, D), lay + ("heads", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec(stacked + (dh,), lay + (None,), "ones")
        p["k_norm"] = ParamSpec(stacked + (dh,), lay + (None,), "ones")
    return p


def _project_q(params, cfg, x, positions, use_rope=True):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(params, cfg, src):
    """k (``k_norm``-ed, not rotated) and v from ``src`` [B,T,D]."""
    B, T, _ = src.shape
    K, dh = cfg.n_kv_heads, cfg.head_dim
    k = (src @ params["wk"]).reshape(B, T, K, dh)
    v = (src @ params["wv"]).reshape(B, T, K, dh)
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"])
    return k, v


def _project_qkv(params, cfg, x, positions, use_rope=True):
    q = _project_q(params, cfg, x, positions, use_rope)
    k, v = _project_kv(params, cfg, x)
    if use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _full_attention(q, k, v, causal: bool):
    """q:[B,S,H,dh] k,v:[B,T,K,dh] → [B,S,H,dh] (scores materialized)."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / (dh ** 0.5)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(B, S, H, dh)


def _chunked_attention(q, k, v, causal: bool, chunk: int):
    """Streaming-softmax attention over q/kv blocks (flash-style in plain
    tensor code).  As in the reference, kv blocks above the diagonal are
    masked, not skipped (their compute is still issued)."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if S % chunk or T % chunk:
        return _full_attention(q, k, v, causal)
    nq, nk = S // chunk, T // chunk
    qg = q.reshape(B, nq, chunk, K, G, dh)
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for i in range(nq):
        qi = qg[:, i].float()                            # [B,c,K,G,dh]
        m = torch.full((B, K, G, chunk), NEG_INF, device=q.device)
        s = torch.zeros((B, K, G, chunk), device=q.device)
        o = torch.zeros((B, K, G, chunk, dh), device=q.device)
        for j in range(nk):
            kj = k[:, j * chunk:(j + 1) * chunk].float()
            vj = v[:, j * chunk:(j + 1) * chunk].float()
            logits = torch.einsum("bqkgd,btkd->bkgqt", qi, kj) / (dh ** 0.5)
            if causal:
                qpos = i * chunk + ar[:, None]
                kpos = j * chunk + ar[None, :]
                logits = torch.where(qpos >= kpos, logits, NEG_INF)
            mn = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - mn[..., None])
            corr = torch.exp(m - mn)
            s = s * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vj)
            m = mn
        out = (o / torch.clamp(s[..., None], min=1e-30)).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B,c,K,G,dh]
    return torch.stack(outs, dim=1).reshape(B, S, H, dh)


def _out_proj(params, out, cfg):
    B, S = out.shape[0], out.shape[1]
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]


def attention(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, kv: torch.Tensor | None = None,
              use_rope: bool = True) -> torch.Tensor:
    """Self- (or cross-, via ``kv`` [B,T,D]) attention over a full
    sequence.  x: [B,S,D] → [B,S,D].  Cross-attention takes q from x and
    k, v from ``kv``; RoPE (at ``positions``) rotates q only and
    ``k_norm`` applies to k, as in the reference."""
    if kv is None:
        q, k, v = _project_qkv(params, cfg, x, positions, use_rope)
    else:
        q = _project_q(params, cfg, x, positions, use_rope)
        k, v = _project_kv(params, cfg, kv)
    return _out_proj(params, _attention_core(q, k, v, causal, cfg), cfg)


def _attention_core(q, k, v, causal, cfg):
    """Dispatch the attention plan: flash kernel / chunked / full."""
    if cfg.pad_heads:
        raise NotImplementedError(
            "pad_heads (TP head padding) is a mesh lever: ROADMAP.md A7.5")
    S, T = q.shape[1], k.shape[1]
    if cfg.attn_impl in ("flash", "flash_interpret"):
        from ..kernels.attention import mha
        mode = "interpret" if cfg.attn_impl == "flash_interpret" else None
        return mha(q, k, v, causal, mode)
    if S > cfg.attn_chunk and S % cfg.attn_chunk == 0 \
            and T % cfg.attn_chunk == 0:
        return _chunked_attention(q, k, v, causal, cfg.attn_chunk)
    return _full_attention(q, k, v, causal)


def prefill_attention(params: dict, cfg, x, positions, use_rope: bool = True):
    """Like ``attention`` but also returns the KV cache for decode, K/V
    stored flattened [B, S, K·dh]."""
    q, k, v = _project_qkv(params, cfg, x, positions, use_rope)
    B, S = x.shape[0], x.shape[1]
    out = _attention_core(q, k, v, True, cfg)
    kd = cfg.n_kv_heads * cfg.head_dim
    cache = KVCache(k=k.reshape(B, S, kd), v=v.reshape(B, S, kd))
    return _out_proj(params, out, cfg), cache


def _quantize_kv(x: torch.Tensor):
    """x [B, K, dh] → (int8 [B, K·dh], fp32 scale [B, K]): max|x| over dh
    / 127, floored at 1e-8, rounded half to even and clipped to ±127, as
    the reference's ``_quantize_kv``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape[0], -1), scale


def decode_attention(params: dict, cfg, x: torch.Tensor, cache,
                     pos: int, update_cache: bool = True,
                     use_rope: bool = True):
    """One-token decode: x [B,1,D], cache [B,T,K·dh] (flattened), pos int.

    Writes the new K/V at ``pos`` into ``cache`` IN PLACE (the reference
    returns an updated copy; at Phi-4-mini's width a copy per layer and
    step would move the whole cache) and attends over positions ≤ pos.
    ``cache`` is a ``KVCache`` or a ``QuantKVCache``: into the int8 one
    the new K/V go quantized, their scales beside them, and the whole
    cache is read back as ``int8 · scale`` in ``cfg.dtype``.  With
    ``update_cache=False`` it projects q alone, writes nothing and
    attends over the cache's positions ≤ pos (Whisper's cross K/V, shared
    by every step).  Returns (out, cache).  A ``pos`` past the cache
    raises ``IndexError`` where it writes (the reference's
    ``dynamic_update_slice`` would clamp it).
    """
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    quant = isinstance(cache, QuantKVCache)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    if update_cache:
        q, k_new, v_new = _project_qkv(params, cfg, x, positions, use_rope)
        if quant:
            for new, vals, scales in ((k_new, cache.k, cache.k_scale),
                                      (v_new, cache.v, cache.v_scale)):
                qv, sc = _quantize_kv(new.reshape(B, K, dh))
                vals[:, pos] = qv
                scales[:, pos] = sc
        else:
            cache.k[:, pos] = k_new.reshape(B, K * dh).to(cache.k.dtype)
            cache.v[:, pos] = v_new.reshape(B, K * dh).to(cache.v.dtype)
    else:
        q = _project_q(params, cfg, x, positions, use_rope)
    T = cache.k.shape[1]
    k = cache.k.reshape(B, T, K, dh)
    v = cache.v.reshape(B, T, K, dh)
    if quant:
        k = k.to(cfg.dtype) * cache.k_scale[..., None].to(cfg.dtype)
        v = v.to(cfg.dtype) * cache.v_scale[..., None].to(cfg.dtype)
    qg = q.reshape(B, K, H // K, dh)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                          k.float()) / (dh ** 0.5)
    mask = torch.arange(T, device=x.device)[None, None, None, :] <= pos
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype), v)
    return _out_proj(params, out.reshape(B, 1, H, dh), cfg), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(d: int, f: int, act: str, stacked: tuple[int, ...] = ()) -> dict:
    lay = ("layers",) * len(stacked)
    p = {
        "w_up": ParamSpec(stacked + (d, f), lay + ("embed", "mlp")),
        "w_down": ParamSpec(stacked + (f, d), lay + ("mlp", "embed")),
    }
    if act == "swiglu":
        p["w_gate"] = ParamSpec(stacked + (d, f), lay + ("embed", "mlp"))
    return p


def mlp_apply(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ params["w_up"]
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    elif act == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown activation {act!r}")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> dict:
    p = {"embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((cfg.d_model, cfg.vocab),
                                 ("embed", "vocab"))
    return p
