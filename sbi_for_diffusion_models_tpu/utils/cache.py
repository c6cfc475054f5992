"""Persistent compilation cache setup.

First compiles of the big programs (16k-step simulator, NUTS over the MNLE
potential) take tens of seconds and recur in every fresh process. JAX's
persistent compilation cache amortizes them across processes. Call
``enable_persistent_cache()`` before the first jit; the pipeline CLI and the
benchmark scripts do this.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here changes it. Otherwise the cache sits at a fixed path inside the
checkout (``.jax_cache/`` beside the package): the path is part of the
cache's key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_persistent_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
