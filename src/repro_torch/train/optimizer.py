"""Optimizers and schedules as optax-style gradient transformations.

Port of ``src/repro/train/optimizer.py``: ``adam`` / ``adamw`` (decoupled
weight decay), ``adafactor`` (factored second moments, the 340B/398B
configs' optimizer), ``clip_by_global_norm``, ``scale_by_schedule``,
``chain``, ``warmup_cosine``, ``constant_schedule``, ``global_norm`` and
``apply_updates``, as functions over nested dicts/lists of tensors, with
the reference's formulas.

``adam`` is functional by default: every update returns new tensors and
leaves its inputs as they were (the in-situ trainer relies on it).  With
``inplace=True`` it updates μ and ν in place and writes the updates into
the gradients' storage, and ``apply_updates(..., inplace=True)`` adds
them into the params.  ``clip_by_global_norm``, ``adamw`` and
``adafactor`` serve the LM train step, where the reference donates its
state, and always work in place: ``adamw`` is ``adam(...,
inplace=True)``, ``adafactor`` updates its factors in place and writes
its updates into the gradients' storage.  The in-place paths work on
pieces of at most ``PIECE`` elements (rows of the last axis), so their
temporaries stay small whatever the model's size; ``adam``'s compute bit
for bit what the functional path computes.

The gradients may be fp32 (the train step's sum over micro-batches) or
in the params' dtype (one micro-batch: autograd's gradients as they
are, as the reference hands them on).  The clip scales fp32 gradients
in place.  Other gradients it leaves as they are and returns them
wrapped in :class:`Scaled` with the clip's factor; ``adam`` and
``adafactor`` then read each piece as ``fp32(g) * scale``, the value
the reference's clip makes, so no fp32 copy of a gradient tree is ever
held.  The updates go back into the gradients' storage in their dtype,
which is the params' dtype there, so ``apply_updates`` adds what the
reference's ``p + u.astype(p.dtype)`` adds.

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

__all__ = ["GradientTransformation", "AdamState", "AdafactorState",
           "Scaled", "adam", "adamw", "adafactor", "apply_updates", "chain",
           "clip_by_global_norm", "scale_by_schedule", "warmup_cosine",
           "constant_schedule", "global_norm", "PIECE"]

#: elements per piece of the in-place paths, whole rows of the last axis
#: (a Phi-4-mini MLP leaf's period is 2.5e7; Nemotron-4's embedding is cut
#: into 141 pieces of 1,820 rows)
PIECE = 1 << 25


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    #: ``update(grads, state, params) -> (updates, state)``
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


class Scaled(NamedTuple):
    """Gradients that ``clip_by_global_norm`` did not scale in place
    (they are not fp32): each leaf reads as ``fp32(g) * scale``."""
    grads: Any
    scale: torch.Tensor     # fp32 0-d


def _unscaled(grads) -> tuple[Any, torch.Tensor | None]:
    return (grads.grads, grads.scale) if isinstance(grads, Scaled) \
        else (grads, None)


def _read(g: torch.Tensor, scale) -> torch.Tensor:
    """A gradient piece as the fp32 value the transform works on."""
    g = g.to(torch.float32)
    return g if scale is None else g * scale


def _pieces(t: torch.Tensor) -> list:
    """Views of ``t`` of at most ``PIECE`` elements, whole rows of its last
    axis (at least one row)."""
    if t.dim() < 2 or t.numel() <= PIECE:
        return [t]
    rows = t.view(-1, t.shape[-1])
    return list(rows.split(max(1, PIECE // t.shape[-1]), 0))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32: one
    ``vector_norm`` per fp32 leaf, one per piece of any other (no squared
    or fp32 copy of a leaf)."""
    total = None
    for x in tree_leaves(tree):
        for piece in ([x] if x.dtype == torch.float32 else _pieces(x)):
            sq = torch.square(torch.linalg.vector_norm(piece,
                                                       dtype=torch.float32))
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
    """Scales the gradients by ``min(1, max_norm / (norm + 1e-9))``: fp32
    gradients in place; any others are returned as they are, wrapped in
    :class:`Scaled` with that factor, for ``adam`` / ``adafactor`` to
    apply piece by piece."""
    def init(params):
        return ()

    def update(grads, state, params):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        leaves = tree_leaves(grads)
        if any(g.dtype != torch.float32 for g in leaves):
            return Scaled(grads, scale), state
        for g in leaves:
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
        grads, scale = _unscaled(grads)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            for gs, ms, vs, ps in zip(*map(_pieces, (g, m, v, p))):
                gf = _read(gs, scale)
                ms.copy_(_mu(ms, gf))
                vs.copy_(_nu(vs, gf))
                gs.copy_(_upd(ms, vs, ps))
        return grads, AdamState(step=step, mu=state.mu, nu=state.nu)

    return GradientTransformation(init, update)


def adamw(lr: float | Callable = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          mu_dtype: torch.dtype = torch.float32) -> GradientTransformation:
    """AdamW, in place (see the module's docstring)."""
    return adam(lr, b1, b2, eps, weight_decay, mu_dtype, inplace=True)


class AdafactorState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    vr: Any     # row second moments (factored leaves) or the full v
    vc: Any     # column second moments (a 0-d zero for unfactored leaves)


def _matrix_blocks(M: int, R: int, C: int):
    """(matrices, rows) slices of an [M, R, C] view, each block at most
    ``PIECE`` elements: whole matrices while one fits, else rows of one."""
    if R * C <= PIECE:
        mb = max(1, PIECE // (R * C))
        for m0 in range(0, M, mb):
            yield slice(m0, m0 + mb), slice(None)
        return
    rb = max(1, PIECE // C)
    for m in range(M):
        for r0 in range(0, R, rb):
            yield slice(m, m + 1), slice(r0, r0 + rb)


def adafactor(lr: float | Callable = 1e-2, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              decay_pow: float = 0.8) -> GradientTransformation:
    """Factored second moments (Shazeer & Stern 2018), in place.

    A leaf of ndim >= 2 keeps row and column moments over its last two
    axes (``vr`` of ``p.shape[:-1]``, ``vc`` of ``p.shape[:-2] +
    p.shape[-1:]``: a stacked leaf has one factor pair a period); smaller
    leaves keep the full ``v``.  ``beta = 1 - (step + 1)^-decay_pow`` and
    the eps terms are the reference's, and each leaf's update is clipped
    to RMS ``clip_threshold``.  A factored leaf runs in blocks
    (``_matrix_blocks``) over three passes that each read the gradient:
    the row moments and the column sums, then the update's RMS, then the
    update written into the gradient's storage; so its temporaries are a
    few blocks of fp32, never a copy of the leaf (the reference's
    expression would hold three at the embedding's [256,000, 18,432])."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None

        def zeros(p, shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            vr=tree_map(lambda p: zeros(p, p.shape[:-1] if p.dim() >= 2
                                        else p.shape), params),
            vc=tree_map(lambda p: zeros(p, p.shape[:-2] + p.shape[-1:]
                                        if p.dim() >= 2 else ()), params))

    def _factored(g, vr, vc, scale, beta, lr_t):
        R, C = g.shape[-2], g.shape[-1]
        M = g.numel() // (R * C)
        g3, vr2, vc2 = g.view(M, R, C), vr.view(M, R), vc.view(M, C)
        blocks = list(_matrix_blocks(M, R, C))
        colsum = torch.zeros((M, C), dtype=torch.float32, device=g.device)
        for ms, rs in blocks:           # vr, and the sums behind vc
            g2 = torch.square(_read(g3[ms, rs], scale)) + eps
            vr2[ms, rs] = beta * vr2[ms, rs] + (1 - beta) * g2.mean(-1)
            colsum[ms] += g2.sum(-2)
            del g2
        vc2.copy_(beta * vc2 + (1 - beta) * (colsum / R))
        del colsum
        rfac = torch.sqrt(vr2.mean(-1) + eps)

        def u_of(ms, rs):
            return _read(g3[ms, rs], scale) \
                * torch.rsqrt(vr2[ms, rs, None] + eps) \
                * torch.rsqrt(vc2[ms, None, :] + eps) \
                * rfac[ms, None, None]

        sq = None                       # the update's RMS over the leaf
        for ms, rs in blocks:
            part = torch.square(u_of(ms, rs)).sum()
            sq = part if sq is None else sq + part
        rms = torch.sqrt(sq / g.numel() + 1e-12)
        denom = torch.clamp(rms / clip_threshold, min=1.0)
        for ms, rs in blocks:
            g3[ms, rs] = -lr_t * (u_of(ms, rs) / denom)

    def update(grads, state, params):
        grads, scale = _unscaled(grads)
        step = state.step + 1
        beta = 1.0 - torch.pow(step.to(torch.float32) + 1.0, -decay_pow)
        lr_t = sched(state.step)
        for g, vr, vc in zip(tree_leaves(grads), tree_leaves(state.vr),
                             tree_leaves(state.vc)):
            if g.dim() >= 2:
                _factored(g, vr, vc, scale, beta, lr_t)
                continue
            gf = _read(g, scale)
            vr.copy_(beta * vr + (1 - beta) * (torch.square(gf) + eps))
            u = gf * torch.rsqrt(vr + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            g.copy_(-lr_t * (u / torch.clamp(rms / clip_threshold,
                                              min=1.0)))
        return grads, AdafactorState(step=step, vr=state.vr, vc=state.vc)

    return GradientTransformation(init, update)
