"""Serving substrate — port of ``src/repro/serve``: continuous batching
and the store-backed serving plane (``ServeLoop``).  The greedy decode
loops of the LM zoo are a later slice (``ROADMAP.md`` A7)."""

from . import batching, engine
from .batching import Batcher, Request
from .engine import ServeLoop, request_key, submitted_meta

__all__ = ["batching", "engine", "Batcher", "Request", "ServeLoop",
           "request_key", "submitted_meta"]
