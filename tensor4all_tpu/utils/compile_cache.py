"""Where the persistent XLA compilation cache lives.

One rule for every entry point of this checkout (``chip_smoke.py``,
``bench.py``): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and
nothing here overrides it; otherwise the cache is ``.jax_cache/`` at the
root of the checkout, a fixed path (the path is part of the cache key,
so a moving directory never hits) that ``.gitignore`` lists.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Apply the rule above before the first compilation; return the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
