"""JAX's persistent compilation cache for the program's entry points."""

from __future__ import annotations

import os

# Fixed, inside the checkout, listed in .gitignore: the cache key holds
# the path, so a directory that moves never hits.
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory (JAX reads
    it itself) and no other is set.  Otherwise the cache lives in
    ``.jax_cache/<platform>`` of the checkout: XLA:CPU entries embed the
    host's machine features, so platforms do not share a directory.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT_CACHE, jax.default_backend())
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
