"""Host data pipeline — port of ``src/repro/data``: the synthetic token
stream and its background prefetch."""

from .pipeline import PrefetchIterator, TokenStream

__all__ = ["TokenStream", "PrefetchIterator"]
