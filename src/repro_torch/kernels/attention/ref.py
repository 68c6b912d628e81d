"""Plain PyTorch versions of causal GQA attention and its backward.

``mha_ref`` is a copy of ``src/repro/kernels/attention/ref.py::mha_ref``
(the oracle the reference's kernel is tested against; ``mha`` takes it
for CPU tensors).  ``flash_attention_ref`` is the plain version of the
forward kernel itself — the same function with the log-sum-exp the
backward kernels consume, all arithmetic in fp32 and the output cast to
q's dtype once at the end, as the kernel does — and is what the kernel is
held to on the card.  ``flash_attention_bwd_ref`` is the plain version of
the two backward kernels (``src/repro/kernels/attention/bwd.py``): P
recomputed from the forward's log-sum-exp, ``D = rowsum(do ∘ o)``, every
product in fp32, and dq, dk, dv cast to the inputs' dtypes once; dk and dv
are summed over the G query heads of each kv head, as the reference's
``ops.py`` group-sums them.  All mask top-left (``qpos >= kpos``, no
``T − S`` offset) with ``-1e30``.
"""

from __future__ import annotations

import torch

__all__ = ["mha_ref", "flash_attention_ref", "flash_attention_bwd_ref"]

NEG_INF = -1e30


def _logits(q, k, causal: bool, prescale: bool = False) -> torch.Tensor:
    """fp32 logits [B, K, G, S, T] of q [B,S,H,dh] against k [B,T,K,dh];
    ``prescale`` multiplies q by the scale before the dot, as the kernels
    do, instead of dividing the dot by ``sqrt(dh)``."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh).float()
    if prescale:
        logits = torch.einsum("bskgd,btkd->bkgst", qg * (1.0 / dh ** 0.5),
                              k.float())
    else:
        logits = torch.einsum("bskgd,btkd->bkgst", qg,
                              k.float()) / (dh ** 0.5)
    if causal:
        mask = torch.arange(S, device=q.device)[:, None] \
            >= torch.arange(T, device=q.device)[None, :]
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def mha_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: [B,S,H,dh]; k,v: [B,T,K,dh] (H = G·K grouped) → [B,S,H,dh]."""
    B, S, H, dh = q.shape
    p = torch.softmax(_logits(q, k, causal), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v)
    return out.reshape(B, S, H, dh)


def flash_attention_ref(q, k, v, causal: bool = True):
    """→ (o [B,S,H,dh] in q's dtype, lse fp32 [B,S,H])."""
    B, S, H, dh = q.shape
    logits = _logits(q, k, causal)
    lse = torch.logsumexp(logits, dim=-1)                   # [B,K,G,S]
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return (out.reshape(B, S, H, dh).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(B, S, H))


def flash_attention_bwd_ref(q, k, v, o, do, lse, causal: bool = True):
    """q, o, do: [B,S,H,dh]; k, v: [B,T,K,dh]; lse fp32 [B,S,H] →
    (dq [B,S,H,dh], dk, dv [B,T,K,dh]) in the inputs' dtypes."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / dh ** 0.5
    logits = _logits(q, k, causal, prescale=True)           # [B,K,G,S,T]
    lse_g = lse.float().reshape(B, S, K, G).permute(0, 2, 3, 1)
    p = torch.exp(logits - lse_g[..., None])
    del logits
    dog = do.float().reshape(B, S, K, G, dh)
    delta = (dog * o.float().reshape(B, S, K, G, dh)).sum(-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    del dp
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.float().reshape(B, S, K, G, dh)) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
