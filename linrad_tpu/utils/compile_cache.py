"""Persistent XLA compile cache placement for the entry points.

Compiling the full receive chain takes tens of seconds; a persistent
cache turns every later start of the same configuration into a load.
The cache key includes its directory, so the directory must not move
between runs: it is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX
reads the variable itself), and otherwise ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os

CACHE_DIRNAME = ".jax_cache"
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> str:
    """The directory that holds the ``linrad_tpu`` package."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its fixed place and
    return that directory.  Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(checkout_root(), CACHE_DIRNAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
