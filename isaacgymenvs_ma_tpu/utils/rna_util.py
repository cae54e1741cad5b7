"""Random Network Adversary (reference utils/rna_util.py:37-163).

Dextreme's action-perturbation adversary: a fixed random MLP with softmax-
binned outputs and periodically refreshed dropout masks produces structured
adversarial action noise.  Parameters are sampled
once (never trained); dropout masks live in the carry and refresh on demand.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..learning import nn


@dataclass(frozen=True)
class _RNANet(nn.Module):
    num_actions: int
    num_bins: int = 32
    units: tuple = (512, 512)

    def __call__(self, scope, obs, masks):
        x = obs
        for i, u in enumerate(self.units):
            x = nn.dense(scope.child(f"fc{i}"), x, u)
            x = jax.nn.relu(x) * masks[i]  # dropout-style random gating
        logits = nn.dense(scope.child("out"), x,
                          self.num_actions * self.num_bins)
        logits = logits.reshape(obs.shape[0], self.num_actions, self.num_bins)
        # softmax-binned continuous outputs in [-1, 1] (ref :118-139)
        bins = jnp.linspace(-1.0, 1.0, self.num_bins)
        probs = jax.nn.softmax(logits, axis=-1)
        return jnp.sum(probs * bins, axis=-1)


class RNAState(NamedTuple):
    params: dict
    masks: tuple   # per-layer (units,) {0,1} masks
    key: jax.Array


class RandomNetworkAdversary:
    def __init__(self, num_obs: int, num_actions: int, num_bins: int = 32,
                 units=(512, 512), dropout_p: float = 0.5):
        self.net = _RNANet(num_actions, num_bins, tuple(units))
        self.num_obs = num_obs
        self.units = tuple(units)
        self.dropout_p = dropout_p

    def init(self, key) -> RNAState:
        k1, k2 = jax.random.split(key)
        masks = tuple(jnp.ones((u,), jnp.float32) for u in self.units)
        params = self.net.init(k1, jnp.zeros((1, self.num_obs)), masks)
        st = RNAState(params=params, masks=masks, key=k2)
        return self.refresh(st)

    def refresh(self, state: RNAState) -> RNAState:
        """Resample dropout masks (ref refresh at DR frequency)."""
        key, *ks = jax.random.split(state.key, len(self.units) + 1)
        masks = tuple(
            (jax.random.uniform(k, (u,)) > self.dropout_p).astype(jnp.float32)
            / (1.0 - self.dropout_p)
            for k, u in zip(ks, self.units))
        return RNAState(params=state.params, masks=masks, key=key)

    def __call__(self, state: RNAState, obs) -> jax.Array:
        return self.net.apply(state.params, obs, state.masks)
