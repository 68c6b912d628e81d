"""Train state and optimizer wiring for the LM.

Port of ``src/repro/train/train_state.py``: ``TrainState``, ``make_tx``
(global-norm clipping, then AdamW on a 3e-4 warmup-cosine schedule, or
Adafactor on a 1e-2 one for the 340B/398B configs) and
``init_train_state``, plus ``train_state_from_numpy``, which carries the
reference's train state across (its params and optimizer state as
numpy trees in ``launch.steps.model_specs`` layout: the LM's or
Whisper's).  The optimizer state has the
reference's structure, ``chain(clip, inner)`` → ``((), AdamState(step,
mu, nu))`` or ``((), AdafactorState(step, vr, vc))``.  ``make_tx``'s
transforms update in place (see ``train.optimizer``): the reference's
train step donates its state.  The dry-run's ``abstract_*``
constructors are ``ROADMAP.md`` A7.7.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import init_params, lm_params_from_numpy
from ..tree import tree_map
from . import optimizer as opt

__all__ = ["TrainState", "make_tx", "init_train_state",
           "train_state_from_numpy"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor      # int32 scalar


def make_tx(cfg, total_steps: int = 100_000) -> opt.GradientTransformation:
    adafactor = cfg.optimizer == "adafactor"
    sched = opt.warmup_cosine(1e-2 if adafactor else 3e-4,
                              warmup_steps=min(2000, total_steps // 10),
                              total_steps=total_steps)
    if adafactor:
        inner = opt.adafactor(lr=sched)
    else:
        inner = opt.adamw(lr=sched, b1=0.9, b2=0.95, weight_decay=0.1)
    return opt.chain(opt.clip_by_global_norm(1.0), inner)


def init_train_state(generator: torch.Generator, cfg, specs, tx,
                     dtype=None, device=None) -> TrainState:
    """Params drawn by ``init_params`` (``generator`` on ``device``), the
    optimizer's zero state, step 0."""
    device = resolve_device(device)
    params = init_params(specs, generator, dtype or cfg.dtype, device)
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def train_state_from_numpy(params, cfg, mu=None, nu=None, step: int = 0,
                           device=None, vr=None, vc=None) -> TrainState:
    """The reference's train state as the port's: ``params`` in
    ``cfg.dtype`` in ``model_specs(cfg)`` layout; the optimizer's state in
    fp32, zeros where ``None``: Adam's ``mu``/``nu`` (params-shaped), or
    for an Adafactor config its ``vr``/``vc`` (each leaf's row and column
    moments, the reference's ``AdafactorState`` layout); ``step`` is both
    the optimizer's step and the train step."""
    dev = resolve_device(device)
    p = lm_params_from_numpy(params, cfg, dev)
    step_t = torch.tensor(step, dtype=torch.int32, device=dev)
    if cfg.optimizer == "adafactor":
        zero = opt.adafactor().init(p)
        inner = opt.AdafactorState(
            step=step_t.clone(),
            vr=zero.vr if vr is None else _moments(vr, zero.vr, dev),
            vc=zero.vc if vc is None else _moments(vc, zero.vc, dev))
        return TrainState(params=p, opt_state=((), inner), step=step_t)

    def moment(tree):
        if tree is None:
            return tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                            p)
        return lm_params_from_numpy(tree, cfg, dev, dtype=torch.float32)

    inner = opt.AdamState(step=step_t.clone(), mu=moment(mu), nu=moment(nu))
    return TrainState(params=p, opt_state=((), inner), step=step_t)


def _moments(tree, like, device):
    """A numpy tree of factored moments in ``like``'s structure and
    shapes (fp32 on ``device``); a leaf of another shape raises."""
    def leaf(z, a):
        # a copy: the optimizer updates its state in place
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
        if t.shape != z.shape:
            raise ValueError(f"adafactor moment of shape {tuple(t.shape)}, "
                             f"expected {tuple(z.shape)}")
        return t
    return tree_map(leaf, like, tree)   # like's order: the params'
