"""Persistent XLA compilation cache.

Compiling the graph programs takes tens of seconds on a cold process; the
persistent cache makes each program a one-time cost across processes. Enabled
by bench.py, the apps, chip_smoke.py and the test suite."""
from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set (JAX reads it too), else a fixed
    directory in the checkout — a fixed path keeps cache keys stable."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def enable_persistent_cache() -> None:
    import jax
    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
