"""Serving loop: prefill + continuous-batching greedy decode.

Port of ``src/repro/serve/decode.py``: drives ``lm.prefill`` /
``lm.decode_step`` against the ``Batcher``, on the device the params live
on, under ``torch.no_grad()``, for any decoder-only config (dense, MoE,
SSM, hybrid).  Each decode step of ``serve_loop`` can
capture the step's logits into the co-located store (``capture_table``)
— the paper's in-situ inference applied to LM serving.

``serve_loop`` reproduces the reference as written, including its shared
position: every slot writes and attends at ``pos = max(pos_per_slot)``
(``src/repro/serve/decode.py:77``), so a slot admitted while another is
deeper into its sequence starts at that deeper position.  That is the
reference's behaviour, kept so the two agree (``ROADMAP.md`` §C).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import lm
from .batching import Batcher

__all__ = ["greedy_generate", "serve_loop"]


@torch.no_grad()
def greedy_generate(params, cfg, prompt_tokens: torch.Tensor, max_new: int,
                    t_max: int | None = None) -> torch.Tensor:
    """Single-batch greedy decode.

    prompt_tokens: [B, S0].  Returns [B, max_new] generated ids (int64).
    """
    dev = params["embed"].device
    prompt_tokens = torch.as_tensor(prompt_tokens, device=dev)
    B, S0 = prompt_tokens.shape
    t_max = t_max or (S0 + max_new)
    logits, caches, pos = lm.prefill(params, cfg, prompt_tokens, t_max=t_max)
    out = []
    token = logits.argmax(-1)[:, None]
    for i in range(max_new):
        out.append(token)
        logits, caches = lm.decode_step(params, cfg, caches, token, pos + i)
        token = logits.argmax(-1)[:, None]
    return torch.cat(out, dim=1)


@torch.no_grad()
def serve_loop(params, cfg, batcher: Batcher, t_max: int,
               max_steps: int = 1000, capture_client=None,
               capture_table: str = "serving"):
    """Continuous batching: admit → decode-step → retire, until idle.

    All slots share one fixed-shape cache of depth ``t_max``; admissions
    feed their prompt into their slot one token per step (simple and
    shape-stable).  Returns (completed requests, steps, tok/s).
    """
    dev = params["embed"].device
    B = batcher.max_batch
    caches = lm.init_caches(cfg, B, t_max, device=dev)
    tokens = np.zeros((B, 1), np.int64)
    pos_per_slot = np.zeros(B, np.int32)
    pending_prompt: dict[int, list[int]] = {}

    t0 = time.perf_counter()
    steps = 0
    total_tokens = 0
    while steps < max_steps and not batcher.idle:
        for slot, req in batcher.admit():
            pending_prompt[slot] = list(req.prompt)
            pos_per_slot[slot] = 0
        # feed: prompt token if pending, else last generated token
        feeding = np.zeros(B, bool)
        for i in range(B):
            if pending_prompt.get(i):
                tokens[i, 0] = pending_prompt[i].pop(0)
                feeding[i] = True
        pos = int(pos_per_slot.max())
        logits, caches = lm.decode_step(params, cfg, caches,
                                        torch.from_numpy(tokens).to(dev), pos)
        steps += 1
        nxt = logits.argmax(-1).cpu().numpy()
        active = batcher.active_mask()
        emit = active & ~feeding
        if emit.any():
            batcher.record_tokens(np.where(emit, nxt, 0))
            total_tokens += int(emit.sum())
        for i in range(B):
            if active[i] or feeding[i]:
                pos_per_slot[i] += 1
            if not feeding[i] and active[i]:
                tokens[i, 0] = int(nxt[i])
        if capture_client is not None and steps % 8 == 0:
            capture_client.send_step(capture_table, steps, logits)
    dt = time.perf_counter() - t0
    return batcher.completed, steps, total_tokens / max(dt, 1e-9)
