"""Persistent XLA compilation cache helper.

Big one-jit chains (adaptive equalizer scans, SSFM loops, LDPC decoders) can
take many seconds to compile cold; JAX's persistent compilation cache lets
every later process load them instead. The reference has no compilation step
at all (Numba caches per-function machine code transparently); this is the
framework-level equivalent.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and this module
  sets no directory.
- otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``). The path
  is fixed because it is part of the cache key: a directory that moves
  never hits.
"""

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "cache_dir", "enable_persistent_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def cache_dir(path=None):
    """The cache directory :func:`enable_persistent_cache` would use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or path or \
        DEFAULT_CACHE_DIR


def enable_persistent_cache(path=None, min_compile_secs=5.0):
    """Cache compiled XLA programs on disk across processes.

    Parameters
    ----------
    path : cache directory when ``JAX_COMPILATION_CACHE_DIR`` is not set
        (default ``<checkout>/.jax_cache``).
    min_compile_secs : only persist programs that took at least this long
        to compile (keeps the cache small).

    Returns the directory in use.
    """
    d = cache_dir(path)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return d
