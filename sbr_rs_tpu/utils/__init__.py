"""Utilities: checkpointing, metrics/logging, profiling, compile cache."""

from . import checkpoint, compile_cache, metrics

__all__ = ["checkpoint", "compile_cache", "metrics"]
