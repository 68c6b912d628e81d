"""Nested containers of tensors (the port's stand-in for JAX pytrees):
model params, optimizer moments, stacked producer carries; and
``value_and_grad`` over such a tree (``jax.value_and_grad``'s place)."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["tree_map", "tree_leaves", "value_and_grad"]


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts, lists, tuples and named
    tuples (dicts in insertion order); a ``None`` leaf stays ``None``."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        mapped = [tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(head)(*mapped) if hasattr(head, "_fields") \
            else type(head)(mapped)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def value_and_grad(loss_of: Callable, params, has_aux: bool = False):
    """``(loss, grads)`` of ``loss_of(params)`` with the grads in the params'
    tree layout; with ``has_aux``, ``loss_of`` returns ``(loss, aux)`` and
    the result is ``((loss, aux), grads)``.  ``params`` themselves are left
    untouched."""
    leaves: list[torch.Tensor] = []

    def track(p):
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]

    tracked = tree_map(track, params)
    with torch.enable_grad():
        out = loss_of(tracked)
        loss, aux = out if has_aux else (out, None)
        grads = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(grads), params)
    if has_aux:
        return (loss.detach(), tree_map(lambda a: a.detach(), aux)), grads
    return loss.detach(), grads
