"""Nested containers of tensors (the port's stand-in for JAX pytrees):
model params, optimizer moments, stacked producer carries."""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map"]


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
