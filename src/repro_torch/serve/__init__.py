"""Serving substrate — port of ``src/repro/serve``: continuous batching,
the greedy decode loops of the LM (``decode``) and the store-backed
serving plane (``ServeLoop``)."""

from . import batching, decode, engine
from .batching import Batcher, Request
from .engine import ServeLoop, request_key, submitted_meta

__all__ = ["batching", "decode", "engine", "Batcher", "Request",
           "ServeLoop", "request_key", "submitted_meta"]
