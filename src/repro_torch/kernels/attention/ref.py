"""Plain PyTorch versions of causal GQA attention.

``mha_ref`` is a copy of ``src/repro/kernels/attention/ref.py::mha_ref``
(the oracle the reference's kernel is tested against; ``mha`` takes it
for CPU tensors).  ``flash_attention_ref`` is the plain version of the
kernel itself — the same function with the log-sum-exp the backward
kernels consume, all arithmetic in fp32 and the output cast to q's dtype
once at the end, as the kernel does — and is what the kernel is held to
on the card.  Both mask top-left (``qpos >= kpos``, no ``T − S`` offset)
with ``-1e30``.
"""

from __future__ import annotations

import torch

__all__ = ["mha_ref", "flash_attention_ref"]

NEG_INF = -1e30


def _logits(q, k, causal: bool) -> torch.Tensor:
    """fp32 logits [B, K, G, S, T] of q [B,S,H,dh] against k [B,T,K,dh]."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
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
