"""Actor-critic networks (rl_games network-builder equivalent).

Mirrors the rl_games ``actor_critic`` continuous network the reference trains
with (``cfg/train/AntPPO.yaml``: shared MLP trunk, ELU, fixed learnable
log-sigma, mu + value heads).  Configured from the same
``params.network`` schema.  bf16 is intentionally not used: these MLPs are
tiny and f32 keeps the learner bit-stable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax.numpy as jnp

from . import nn

# rl_games' mu head: fan-in truncated normal at 1% of the LeCun variance
_MU_INIT = nn.variance_scaling(0.01, "fan_in", "truncated_normal")


def _log_sigma(scope, fixed_sigma, sigma_init, trunk, mu, num_actions):
    if fixed_sigma:
        log_sigma = scope.param("log_sigma", nn.constant(sigma_init),
                                (num_actions,))
        return jnp.broadcast_to(log_sigma, mu.shape)
    return nn.dense(scope.child("sigma"), trunk, num_actions)


@dataclass(frozen=True)
class ActorCritic(nn.Module):
    """Continuous-action actor-critic with optional separate critic trunk."""

    num_actions: int
    units: Sequence[int] = (256, 128, 64)
    activation: str = "elu"
    separate: bool = False
    fixed_sigma: bool = True
    sigma_init: float = 0.0
    value_size: int = 1

    def __call__(self, scope, obs):
        trunk = nn.mlp(scope.child("actor_mlp"), obs, self.units,
                       self.activation)
        mu = nn.dense(scope.child("mu"), trunk, self.num_actions,
                      kernel_init=_MU_INIT)
        if self.separate:
            vtrunk = nn.mlp(scope.child("critic_mlp"), obs, self.units,
                            self.activation)
        else:
            vtrunk = trunk
        value = nn.dense(scope.child("value"), vtrunk, self.value_size)
        log_sigma = _log_sigma(scope, self.fixed_sigma, self.sigma_init,
                               trunk, mu, self.num_actions)
        return mu, log_sigma, value.squeeze(-1)


@dataclass(frozen=True)
class AsymActorCritic(nn.Module):
    """Actor on obs + central-value critic on privileged states (rl_games
    central_value_config, cfg/train/ShadowHandPPOAsymm.yaml:73-88)."""

    num_actions: int
    units: Sequence[int] = (256, 128, 64)
    cv_units: Sequence[int] = (256, 128)
    activation: str = "elu"
    fixed_sigma: bool = True
    sigma_init: float = 0.0

    def __call__(self, scope, obs, states):
        trunk = nn.mlp(scope.child("actor_mlp"), obs, self.units,
                       self.activation)
        mu = nn.dense(scope.child("mu"), trunk, self.num_actions,
                      kernel_init=_MU_INIT)
        log_sigma = _log_sigma(scope, self.fixed_sigma, self.sigma_init,
                               trunk, mu, self.num_actions)
        vtrunk = nn.mlp(scope.child("critic_mlp"), states, self.cv_units,
                        self.activation)
        value = nn.dense(scope.child("value"), vtrunk, 1)
        return mu, log_sigma, value.squeeze(-1)


def build_network(net_cfg: dict, num_actions: int) -> ActorCritic:
    """Construct from the rl_games ``params.network`` schema."""
    mlp = net_cfg.get("mlp", {})
    space = net_cfg.get("space", {}).get("continuous", {})
    sigma_init = space.get("sigma_init", {}).get("val", 0.0)
    return ActorCritic(
        num_actions=num_actions,
        units=tuple(mlp.get("units", (256, 128, 64))),
        activation=mlp.get("activation", "elu"),
        separate=bool(net_cfg.get("separate", False)),
        fixed_sigma=bool(space.get("fixed_sigma", True)),
        sigma_init=float(sigma_init),
    )


def gaussian_neglogp(mu, log_sigma, actions):
    """Diagonal-gaussian negative log prob (rl_games distr semantics)."""
    var = jnp.exp(2.0 * log_sigma)
    return 0.5 * jnp.sum(
        jnp.square(actions - mu) / var + 2.0 * log_sigma + jnp.log(2.0 * jnp.pi),
        axis=-1,
    )


def gaussian_entropy(log_sigma):
    return jnp.sum(log_sigma + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e), axis=-1)


def gaussian_kl(mu0, log_s0, mu1, log_s1):
    """KL(p0 || p1) for diagonal gaussians (rl_games dist kl)."""
    v0, v1 = jnp.exp(2 * log_s0), jnp.exp(2 * log_s1)
    return jnp.sum(
        log_s1 - log_s0 + (v0 + jnp.square(mu0 - mu1)) / (2.0 * v1) - 0.5, axis=-1)


@dataclass(frozen=True)
class ActorCriticLSTM(nn.Module):
    """MLP trunk -> LSTM -> heads (rl_games ``rnn: {name: lstm}`` networks,
    e.g. cfg/train/ShadowHandPPOLSTM; trained with seq_len truncated BPTT)."""

    num_actions: int
    units: Sequence[int] = (256, 128, 64)
    lstm_units: int = 256
    activation: str = "elu"
    fixed_sigma: bool = True
    sigma_init: float = 0.0

    def __call__(self, scope, obs, carry):
        """obs (B, obs_dim), carry = (h, c) each (B, lstm_units)."""
        x = nn.mlp(scope.child("actor_mlp"), obs, self.units, self.activation)
        (c, h), y = nn.lstm_cell(scope.child("lstm"), (carry[1], carry[0]), x)
        mu = nn.dense(scope.child("mu"), y, self.num_actions,
                      kernel_init=_MU_INIT)
        value = nn.dense(scope.child("value"), y, 1).squeeze(-1)
        log_sigma = _log_sigma(scope, self.fixed_sigma, self.sigma_init,
                               y, mu, self.num_actions)
        return mu, log_sigma, value, (h, c)

    def initial_carry(self, batch: int):
        z = jnp.zeros((batch, self.lstm_units), jnp.float32)
        return (z, z)
