"""Where JAX's persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, wins and JAX reads it itself.
Otherwise the cache goes to a fixed directory inside the checkout, so that
a second run of the same program finds what the first one compiled. The
path is part of the cache key, so it is never built from a temporary name,
a process id or the time.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "use_compile_cache"]

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_SUBDIR = ".jax_cache"


def compile_cache_dir(root: str) -> str:
    """The cache directory for a program run from the checkout at ``root``."""
    return os.environ.get(ENV) or os.path.join(os.path.abspath(root),
                                               DEFAULT_SUBDIR)


def use_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return the path."""
    import jax

    path = compile_cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
