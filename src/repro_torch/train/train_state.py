"""Train state and optimizer wiring for the LM.

Port of ``src/repro/train/train_state.py``: ``TrainState``, ``make_tx``
(AdamW with global-norm clipping on a warmup-cosine schedule) and
``init_train_state``, plus ``train_state_from_numpy``, which carries the
reference's LM train state across (its params and Adam moments as numpy
trees in ``lm.lm_specs`` layout).  The optimizer state has the
reference's structure, ``chain(clip, adamw)`` → ``((), AdamState(step,
mu, nu))``.  ``make_tx``'s transforms update in place (see
``train.optimizer``): the reference's train step donates its state.
Adafactor (the 340B/398B configs) and the dry-run's ``abstract_*``
constructors are ``ROADMAP.md`` A7.
"""

from __future__ import annotations

from typing import Any, NamedTuple

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
    if cfg.optimizer == "adafactor":
        return opt.adafactor()
    sched = opt.warmup_cosine(3e-4, warmup_steps=min(2000, total_steps // 10),
                              total_steps=total_steps)
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
                           device=None) -> TrainState:
    """The reference's LM train state as the port's: ``params`` in
    ``cfg.dtype``, Adam's ``mu``/``nu`` (zeros when ``None``) in fp32,
    all in ``lm.lm_specs`` layout; ``step`` is both the Adam step and the
    train step."""
    if cfg.optimizer == "adafactor":
        return opt.adafactor()
    dev = resolve_device(device)
    p = lm_params_from_numpy(params, cfg, dev)

    def moment(tree):
        if tree is None:
            return tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                            p)
        return lm_params_from_numpy(tree, cfg, dev, dtype=torch.float32)

    step_t = torch.tensor(step, dtype=torch.int32, device=dev)
    inner = opt.AdamState(step=step_t.clone(), mu=moment(mu), nu=moment(nu))
    return TrainState(params=p, opt_state=((), inner), step=step_t)
