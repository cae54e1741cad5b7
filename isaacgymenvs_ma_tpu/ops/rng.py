"""Explicit-key RNG discipline replacing the reference's global torch seeding.

The reference seeds a global torch generator (``utils/utils.py:87-115``,
rank-offset, ``seed=-1`` -> random) and draws with ``torch.rand`` /
``torch_rand_float`` (``utils/torch_jit_utils.py:216-229``).  Here we thread
``jax.random`` keys functionally: every env-state pytree carries a key, resets
split it, and per-rank offsets come from folding in the process index.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def make_seed(seed: int, rank: int = 0, deterministic: bool = False) -> int:
    """Resolve a seed the way the reference does (utils/utils.py:87-103).

    ``seed == -1`` picks a time-based random seed unless ``deterministic``,
    which pins 42.  The rank offset keeps per-host streams decorrelated.
    """
    if deterministic:
        seed = 42
    elif seed == -1:
        seed = int(time.time() * 1e6) % (2**31)
    return seed + rank


def rand_float(key: jax.Array, lower, upper, shape) -> jax.Array:
    """U[lower, upper) sample (ref torch_jit_utils.py:216-219)."""
    return jax.random.uniform(key, shape, jnp.float32, minval=0.0, maxval=1.0) * (upper - lower) + lower


def random_dir_2(key: jax.Array, shape) -> jax.Array:
    """Random planar unit direction (ref torch_jit_utils.py:222-226)."""
    angle = rand_float(key, -jnp.pi, jnp.pi, shape)
    return jnp.stack([jnp.cos(angle), jnp.sin(angle)], axis=-1)


def split_like(key: jax.Array, n: int):
    return tuple(jax.random.split(key, n))
