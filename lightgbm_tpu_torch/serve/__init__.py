"""Serving: the frozen forest, the micro-batcher and the HTTP server."""

from .forest import CompiledForest

__all__ = ["CompiledForest"]
