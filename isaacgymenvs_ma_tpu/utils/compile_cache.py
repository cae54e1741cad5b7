"""JAX's persistent compilation cache, set up once per process.

A cold compile of a task step and a training epoch takes tens of seconds on
a GPU; the cache keeps the executables across processes.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is set
here.  Otherwise the cache lives at a fixed ``.jax_cache`` directory in the
checkout: the directory is part of the cache key, so it must not move
between runs.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def setup_compile_cache() -> str:
    """Point JAX at :func:`cache_dir` and return it."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
