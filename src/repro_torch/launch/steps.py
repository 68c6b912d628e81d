"""Model specs, the LM train step and the serving steps — the
single-device part of ``src/repro/launch/steps.py``.

``make_train_step(cfg)`` returns ``train_step(state, batch) -> (state,
metrics)`` for every config of the registry: the loss and its gradients
by autograd (MoE blocks included: through the router's renormalized
gates and the aux term, the experts and the dispatch), micro-batched over
``cfg.grad_accum`` with the gradients summed in fp32, then the optimizer
of ``make_tx(cfg)`` (its own, with the default 100,000-step schedule, as
the reference builds it).  With one micro-batch the optimizer takes
autograd's gradients as they are, in the params' dtype, as the
reference's does (its ``steps.py:96-98``): the clip and the optimizer
read them piece by piece in fp32 (``train.optimizer``), so no fp32 copy
of the gradients is held (Nemotron-4's would be 51.6 GB at one layer).
Metrics are the last micro-batch's ``ce``, ``aux`` and ``tokens``, the
mean ``loss`` and the ``grad_norm`` of the averaged gradients, as 0-d
tensors on the device.  The reference jits the step with its state
donated; here the state is updated IN PLACE (params and the optimizer's
moments) and the returned state holds the same tensors.

``make_prefill_step(cfg, t_max)`` and ``make_decode_step(cfg)`` return
the serving steps: ``prefill_step(params, batch) -> (logits, caches,
next_pos)``, with a vision config's ``batch["patches"]`` as the prefix
embeds and an encoder-decoder config's ``batch["frames"]`` as the audio
(``models.whisper``: the self caches padded to ``t_max or
tokens.shape[1]``), and ``decode_step(params, caches, token, pos) ->
(logits, caches)``, which updates the caches IN PLACE
(``lm.decode_step``, ``whisper.whisper_decode_step``).  A vision config
trains on ``batch["patches"]`` [B, frontend_tokens, D] (the prefix
embeds), ``["tokens"]`` and ``["labels"]`` over the whole sequence (the
prefix labelled -1); an encoder-decoder config on ``batch["frames"]``,
``["tokens"]`` and ``["labels"]`` (``whisper.whisper_loss``).  Every
entry of a batch splits into the micro-batches along its first axis.
The abstract sharded inputs of the reference's dry-run (``ROADMAP.md``
A7.7) are not ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import lm, whisper
from ..train import optimizer as opt
from ..train.train_state import TrainState, make_tx
from ..tree import tree_leaves, tree_map, value_and_grad

__all__ = ["model_specs", "make_train_step", "make_prefill_step",
           "make_decode_step"]


def model_specs(cfg):
    return whisper.whisper_specs(cfg) if cfg.is_encdec else lm.lm_specs(cfg)


def _loss_fn(cfg) -> Callable:
    if cfg.is_encdec:
        def loss(params, batch):
            return whisper.whisper_loss(params, cfg, batch["frames"],
                                        batch["tokens"], batch["labels"])
    elif cfg.frontend == "vision":
        def loss(params, batch):
            return lm.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                              batch["patches"])
    else:
        def loss(params, batch):
            return lm.lm_loss(params, cfg, batch["tokens"], batch["labels"])
    return loss


def _owned(grads: list) -> list:
    """autograd's gradients, each contiguous and held by no other leaf
    (the optimizer writes its updates into them): a strided or repeated
    one is copied, in its own dtype."""
    seen, out = set(), []
    for g in grads:
        if not g.is_contiguous() or g.data_ptr() in seen:
            g = g.clone(memory_format=torch.contiguous_format)
        seen.add(g.data_ptr())
        out.append(g)
    return out


def make_train_step(cfg) -> Callable:
    tx = make_tx(cfg)
    loss_fn = _loss_fn(cfg)
    accum = max(1, cfg.grad_accum)

    def train_step(state: TrainState, batch):
        gsum: list[torch.Tensor] = []
        lsum = None
        for i in range(accum):
            micro = batch if accum == 1 else {
                k: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])[i]
                for k, x in batch.items()}
            (loss, metrics), grads = value_and_grad(
                lambda p: loss_fn(p, micro), state.params, has_aux=True)
            leaves = tree_leaves(grads)
            del grads
            if accum == 1:      # the reference's branch: as autograd gives
                gsum = _owned(leaves)
            elif i == 0:        # owned and contiguous: updated in place
                gsum = [g.to(torch.float32,
                             memory_format=torch.contiguous_format)
                        for g in leaves]
            else:
                for total, g in zip(gsum, leaves):
                    total.add_(g)
            del leaves
            lsum = loss if lsum is None else lsum + loss
        if accum > 1:
            for g in gsum:
                g.div_(accum)
        it = iter(gsum)
        grads = tree_map(lambda _: next(it), state.params)
        grad_norm = opt.global_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = opt.apply_updates(state.params, updates, inplace=True)
        metrics = dict(metrics, loss=lsum / accum, grad_norm=grad_norm)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg, t_max: int | None = None) -> Callable:
    if cfg.is_encdec:
        def prefill_step(params, batch):
            return whisper.whisper_prefill(
                params, cfg, batch["frames"], batch["tokens"],
                t_max=t_max or batch["tokens"].shape[1])
    elif cfg.frontend == "vision":
        def prefill_step(params, batch):
            return lm.prefill(params, cfg, batch["tokens"],
                              batch["patches"], t_max=t_max)
    else:
        def prefill_step(params, batch):
            return lm.prefill(params, cfg, batch["tokens"], t_max=t_max)
    return prefill_step


def make_decode_step(cfg) -> Callable:
    if cfg.is_encdec:
        def decode_step(params, caches, token, pos):
            return whisper.whisper_decode_step(params, cfg, caches, token,
                                               pos)
    else:
        def decode_step(params, caches, token, pos):
            return lm.decode_step(params, cfg, caches, token, pos)
    return decode_step
