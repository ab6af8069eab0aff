"""Where JAX keeps its persistent compilation cache."""
from __future__ import annotations

import os

# a fixed path inside the checkout (listed in .gitignore), so every process
# started from this checkout finds the executables the last one compiled
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def use_compile_cache() -> str:
    """Enable the persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this does nothing.  Otherwise the cache goes to ``.jax_cache/`` at the
    root of the checkout.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
