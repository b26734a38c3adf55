"""Persistent JAX compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache
and nothing here sets another. Otherwise the cache lives at one fixed
path inside the checkout, ``.jax_cache/`` beside the package (listed in
``.gitignore``): the directory is part of what the cache is keyed on, so
a path that moved between processes would never hit.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_done = False


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str | None:
    """Idempotently enable jax's persistent compilation cache. Returns
    the effective cache dir (None if the default is not writable, or
    the user reset a configured cache)."""
    global _done
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    current = jax.config.jax_compilation_cache_dir
    if current is not None:
        _done = True
        return current
    if _done:  # configured then reset by the user: respect the reset
        return None
    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          float(min_compile_secs))
    except OSError:  # read-only install
        return None
    _done = True
    return DEFAULT_DIR
