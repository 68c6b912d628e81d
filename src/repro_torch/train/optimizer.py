"""Optimizers and schedules as optax-style gradient transformations.

Port of ``src/repro/train/optimizer.py``: ``adam`` / ``adamw`` (decoupled
weight decay), ``clip_by_global_norm``, ``scale_by_schedule``, ``chain``,
``warmup_cosine``, ``constant_schedule``, ``global_norm`` and
``apply_updates``, as functions over nested dicts/lists of tensors, with
the reference's formulas.  ``adafactor`` (the 340B/398B configs'
optimizer) is ``ROADMAP.md`` A7.

``adam`` is functional by default: every update returns new tensors and
leaves its inputs as they were (the in-situ trainer relies on it).  With
``inplace=True`` it updates μ and ν in place and writes the updates into
the gradients' storage, and ``apply_updates(..., inplace=True)`` adds
them into the params.  ``clip_by_global_norm`` and ``adamw`` serve the LM
train step, where the reference donates its state, and always work in
place: the clip scales the gradients, ``adamw`` is ``adam(...,
inplace=True)``.  The in-place paths work on pieces of at most ``PIECE``
elements along the leading axis (a stacked ``[n_periods, ...]`` leaf one
period at a time), so their temporaries stay small whatever the model's
size; they compute bit for bit what the functional path computes, and
take fp32 gradients.

Adam's update is the reference's, not ``torch.optim.Adam``'s: the bias
corrections are computed in fp32 from an int32 step, and the step is
``mhat / (sqrt(vhat) + eps)`` with ``mhat = m / bc1`` and
``vhat = v / bc2`` (``torch.optim.Adam`` adds ``eps`` to
``sqrt(v) / sqrt(bc2)`` and computes the corrections in float64).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["GradientTransformation", "AdamState", "adam", "adamw",
           "adafactor", "apply_updates", "chain", "clip_by_global_norm",
           "scale_by_schedule", "warmup_cosine", "constant_schedule",
           "global_norm", "PIECE"]

#: elements per piece of the in-place paths (a Phi-4-mini MLP leaf's
#: period is 2.5e7; its embedding is cut into 19 pieces of rows)
PIECE = 1 << 25


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    #: ``update(grads, state, params) -> (updates, state)``
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _pieces(t: torch.Tensor) -> list:
    """Views of ``t`` along its leading axis, each at most ``PIECE``
    elements (at least one row)."""
    if t.dim() == 0 or t.numel() <= PIECE:
        return [t]
    rows = max(1, PIECE // (t.numel() // t.shape[0]))
    return list(t.split(rows, 0))


def _need_fp32(g: torch.Tensor, what: str) -> None:
    if g.dtype != torch.float32:
        raise TypeError(f"{what} in place takes float32 gradients, got "
                        f"{g.dtype}")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (one
    ``vector_norm`` per leaf: no squared copy of a leaf)."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.square(torch.linalg.vector_norm(x, dtype=torch.float32))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params, updates, inplace: bool = False):
    """``p + u`` in the params' dtype; ``inplace`` adds into ``params``
    piece by piece and returns them."""
    if not inplace:
        return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        for ps, us in zip(_pieces(p), _pieces(u)):
            ps.add_(us.to(ps.dtype))
    return params


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# Schedules (a step in, an fp32 0-d tensor on the step's device out)
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Callable:
    def sched(step):
        return lr
    return sched


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        # (step+1)/warmup: the first optimizer step gets a nonzero lr
        warm = peak_lr * (step + 1.0) / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scales fp32 gradients in place by ``min(1, max_norm / norm)``."""
    def init(params):
        return ()

    def update(grads, state, params):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        for g in tree_leaves(grads):
            _need_fp32(g, "clip_by_global_norm")
            g.mul_(scale)
        return grads, state

    return GradientTransformation(init, update)


class ScheduleState(NamedTuple):
    step: torch.Tensor      # int32 scalar


def scale_by_schedule(sched: Callable) -> GradientTransformation:
    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return ScheduleState(step=torch.zeros((), dtype=torch.int32,
                                              device=device))

    def update(grads, state, params):
        lr = sched(state.step)
        return (tree_map(lambda g: -lr * g, grads),
                ScheduleState(step=state.step + 1))

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def adam(lr: float | Callable = 1e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         mu_dtype: torch.dtype = torch.float32,
         inplace: bool = False) -> GradientTransformation:
    """Adam / AdamW (decoupled decay).  ``lr`` may be a schedule; the first
    moment μ is kept in ``mu_dtype``, the second in fp32, as the
    reference's."""
    sched = lr if callable(lr) else constant_schedule(lr)
    # the reference's Python scalars are weakly typed: in μ's update they
    # take μ's dtype before they multiply (a no-op for fp32)
    mu_b1, mu_1mb1 = (torch.tensor(c, dtype=mu_dtype).item()
                      for c in (b1, 1 - b1))

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                        params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(state.step)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)      # fp32, on the step's device
        bc2 = 1 - torch.pow(b2, stepf)

        def _mu(m, g):
            return mu_b1 * m + mu_1mb1 * g.to(m.dtype)

        def _nu(v, g):
            return b2 * v + (1 - b2) * torch.square(g.to(torch.float32))

        def _upd(m, v, p):
            mhat = m.to(torch.float32) / bc1
            vhat = v / bc2
            u = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            return -lr_t * u

        if not inplace:
            mu = tree_map(_mu, state.mu, grads)
            nu = tree_map(_nu, state.nu, grads)
            updates = tree_map(_upd, mu, nu, params)
            return updates, AdamState(step=step, mu=mu, nu=nu)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            _need_fp32(g, "adam")
            for gs, ms, vs, ps in zip(*map(_pieces, (g, m, v, p))):
                ms.copy_(_mu(ms, gs))
                vs.copy_(_nu(vs, gs))
                gs.copy_(_upd(ms, vs, ps))
        return grads, AdamState(step=step, mu=state.mu, nu=state.nu)

    return GradientTransformation(init, update)


def adamw(lr: float | Callable = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          mu_dtype: torch.dtype = torch.float32) -> GradientTransformation:
    """AdamW, in place (see the module's docstring)."""
    return adam(lr, b1, b2, eps, weight_decay, mu_dtype, inplace=True)


def adafactor(*args, **kwargs) -> GradientTransformation:
    """The factored second-moment optimizer of the 340B/398B configs."""
    raise NotImplementedError("adafactor (the Nemotron-4 340B and Jamba "
                              "398B configs' optimizer) is ROADMAP.md A7")
