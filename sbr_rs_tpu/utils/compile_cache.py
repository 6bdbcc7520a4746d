"""Persistent XLA compilation cache placed at the checkout root.

Entry-point scripts call :func:`enable_compile_cache` before their first
compilation. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here. Otherwise the cache goes to a fixed
``.jax_cache/`` directory beside the package: the path is part of the
cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at ``.jax_cache/`` unless
    ``JAX_COMPILATION_CACHE_DIR`` already names one. Returns the
    directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
