"""Minimal pure-JAX neural-network layer set (Dense, MLP, LSTM cell).

Every network in the package is a small frozen dataclass whose ``__call__``
takes a :class:`Scope` first.  ``init(key, *x)`` runs it once in creation
mode and returns ``{"params": tree}``; ``apply(variables, *x)`` runs it on
that tree.  Parameter names follow the layout the rl_games-style learners
and checkpoints expect: unnamed layers are ``Dense_0``, ``Dense_1``...; a
Dense layer holds ``kernel`` (in, out) and ``bias``; the LSTM cell holds
input kernels ``ii/if/ig/io`` and recurrent kernels ``hi/hf/hg/ho`` with
biases.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

Initializer = Callable[[jax.Array, tuple], jax.Array]

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
orthogonal = jax.nn.initializers.orthogonal()
variance_scaling = jax.nn.initializers.variance_scaling
uniform = jax.nn.initializers.uniform
constant = jax.nn.initializers.constant


class Scope:
    """One level of the parameter tree.  Creation mode (``key`` given)
    fills ``params``; apply mode (``key`` None) reads it."""

    def __init__(self, params: Optional[dict] = None,
                 key: Optional[jax.Array] = None):
        self.params = {} if params is None else params
        self.key = key
        self._counts: dict = {}
        self._draws = 0

    def _next_key(self) -> jax.Array:
        self._draws += 1
        return jax.random.fold_in(self.key, self._draws)

    def child(self, name: Optional[str] = None, kind: str = "Dense") -> "Scope":
        if name is None:
            i = self._counts.get(kind, 0)
            self._counts[kind] = i + 1
            name = f"{kind}_{i}"
        if self.key is None:
            return Scope(self.params[name])
        sub = Scope({}, self._next_key())
        self.params[name] = sub.params
        return sub

    def param(self, name: str, init: Initializer, shape: tuple) -> jax.Array:
        if self.key is None:
            return self.params[name]
        value = init(self._next_key(), shape, jnp.float32)
        self.params[name] = value
        return value


class Module:
    """Base class: subclasses define ``__call__(self, scope, *inputs)``."""

    def init(self, key: jax.Array, *inputs) -> dict:
        scope = Scope({}, key)
        self(scope, *inputs)
        return {"params": scope.params}

    def apply(self, variables: dict, *inputs):
        return self(Scope(variables["params"]), *inputs)


def dense(scope: Scope, x: jax.Array, features: int,
          kernel_init: Initializer = lecun_normal,
          use_bias: bool = True) -> jax.Array:
    kernel = scope.param("kernel", kernel_init, (x.shape[-1], features))
    y = jnp.dot(x, kernel)
    if use_bias:
        y = y + scope.param("bias", zeros, (features,))
    return y


ACTIVATIONS = {
    "elu": jax.nn.elu,
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "selu": jax.nn.selu,
    "swish": jax.nn.swish,
    "sigmoid": jax.nn.sigmoid,
    "None": lambda x: x,
    None: lambda x: x,
}


def mlp(scope: Scope, x: jax.Array, units, activation: str = "elu"):
    act = ACTIVATIONS[activation]
    for u in units:
        x = act(dense(scope.child(), x, u))
    return x


def lstm_cell(scope: Scope, carry, x: jax.Array):
    """One LSTM step.  ``carry`` = (c, h); returns ((c', h'), h')."""
    c, h = carry
    n = h.shape[-1]
    gates = {}
    for g in "ifgo":
        gates[g] = (dense(scope.child(f"i{g}"), x, n, use_bias=False)
                    + dense(scope.child(f"h{g}"), h, n, kernel_init=orthogonal))
    i = jax.nn.sigmoid(gates["i"])
    f = jax.nn.sigmoid(gates["f"])
    g = jnp.tanh(gates["g"])
    o = jax.nn.sigmoid(gates["o"])
    c_new = f * c + i * g
    h_new = o * jnp.tanh(c_new)
    return (c_new, h_new), h_new
