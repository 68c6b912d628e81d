"""Adam as an optax-style gradient transformation.

Port of ``src/repro/train/optimizer.py`` — the part the in-situ trainer
uses: ``adam`` (with decoupled weight decay) and ``apply_updates``, as
functions over nested dicts/lists of tensors.  They are functional: every
update returns new tensors and leaves its inputs as they were.

The update is the reference's, not ``torch.optim.Adam``'s: the bias
corrections are computed in fp32 from an int32 step, and the step is
``mhat / (sqrt(vhat) + eps)`` with ``mhat = m / bc1`` and
``vhat = v / bc2`` (``torch.optim.Adam`` adds ``eps`` to
``sqrt(v) / sqrt(bc2)`` and computes the corrections in float64).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..tree import tree_map

__all__ = ["GradientTransformation", "AdamState", "adam", "apply_updates",
           "constant_schedule"]


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    #: ``update(grads, state, params) -> (updates, state)``
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def constant_schedule(value: float) -> Callable:
    def sched(step):
        return value
    return sched


class AdamState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def adam(lr: float | Callable = 1e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0
         ) -> GradientTransformation:
    """Adam / AdamW (decoupled decay).  ``lr`` may be a schedule."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        leaves = []
        tree_map(leaves.append, params)
        device = leaves[0].device if leaves else None
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(torch.float32)), state.nu, grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)      # fp32, on the step's device
        bc2 = 1 - torch.pow(b2, stepf)

        def _upd(m, v, p):
            mhat = m.to(torch.float32) / bc1
            vhat = v / bc2
            u = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return -lr_t * u

        updates = tree_map(_upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return GradientTransformation(init, update)
