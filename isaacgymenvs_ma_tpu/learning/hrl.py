"""Hierarchical RL layer (reference learning/hrl_continuous.py:56-159 +
hrl_models.py): a high-level policy emits latent-space actions; each env
step runs ``llc_steps`` of a FROZEN low-level latent-conditioned controller
(the ASE-style AMP policy), averaging rewards over the sub-steps
(ref env_step :74-98).

Batched redesign: instead of a host-side loop around ``vec_env.step``
(ref :81-86), the wrapper is itself a VecTask: ``step(latents)`` lax.scans
``llc_steps`` inner task steps, so the whole hierarchy (HL PPO + LLC
rollouts) stays one XLA program.  The standard :class:`~.ppo.PPOAgent`
trains on the wrapper unchanged — ``num_actions`` becomes ``latent_dim``
(ref _setup_action_space :111-114).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import nn


@dataclass(frozen=True)
class LatentConditionedActor(nn.Module):
    """Low-level controller net: (obs, latent) -> action mean
    (hrl_models.ModelHRLContinuous's LLC head)."""

    num_actions: int
    units: tuple = (1024, 512)

    def __call__(self, scope, obs, latent):
        x = jnp.concatenate([obs, latent], -1)
        x = nn.mlp(scope.child("llc_mlp"), x, self.units, "relu")
        return jnp.tanh(nn.dense(scope.child("mu"), x, self.num_actions))


class HRLEnvState(NamedTuple):
    inner: Any                 # wrapped task EnvState
    last_obs: jax.Array        # (B, num_obs) — LLC conditioning input


class HRLTaskWrapper:
    """Presents a latent-action VecTask over a wrapped task + frozen LLC."""

    dict_obs_cls = False

    def __init__(self, task, llc_apply, llc_params, latent_dim: int,
                 llc_steps: int = 5, extract_llc_obs=None):
        """``llc_apply(params, llc_obs, latent) -> actions in [-1, 1]``;
        ``extract_llc_obs``: slice of the obs the LLC consumes
        (ref _extract_llc_obs :156-158; default = full obs)."""
        self.task = task
        self.llc_apply = llc_apply
        self.llc_params = llc_params
        self.latent_dim = int(latent_dim)
        self.llc_steps = int(llc_steps)
        self.extract_llc_obs = extract_llc_obs or (lambda o: o)
        # VecTask surface
        self.num_envs = task.num_envs
        self.num_obs = task.num_obs
        self.num_states = task.num_states
        self.num_agents = task.num_agents
        self.num_actions = self.latent_dim
        self.rl_games_batch = task.rl_games_batch
        self.max_episode_length = task.max_episode_length
        self.randomizer = None

    def initial_state(self, key):
        inner = self.task.initial_state(key)
        obs = jnp.zeros((self.rl_games_batch, self.num_obs), jnp.float32)
        return HRLEnvState(inner=inner, last_obs=obs)

    def reset(self, state):
        inner, obs = self.task.reset(state.inner)
        return HRLEnvState(inner=inner, last_obs=obs), obs

    def zero_actions(self):
        return jnp.zeros((self.rl_games_batch, self.latent_dim), jnp.float32)

    def get_env_info(self):
        info = dict(self.task.get_env_info())
        info["action_space"] = (self.latent_dim,)
        return info

    def get_env_state(self, state):
        return self.task.get_env_state(state.inner)

    def set_env_state(self, state, env_state):
        return state._replace(inner=self.task.set_env_state(state.inner,
                                                            env_state))

    def set_train_info(self, state, frames):
        return state._replace(inner=self.task.set_train_info(state.inner,
                                                             frames))

    def step(self, state: HRLEnvState, latents: jax.Array):
        """ref env_step :74-98: llc_steps inner steps, rewards averaged,
        dones OR-ed, last sub-step's obs/extras returned."""

        def body(carry, _):
            inner, obs, rew_acc, done_acc = carry
            llc_obs = self.extract_llc_obs(obs)
            actions = self.llc_apply(self.llc_params, llc_obs, latents)
            inner, res = self.task.step(inner, actions)
            rew_acc = rew_acc + res.rew
            done_acc = jnp.maximum(done_acc, res.reset)
            return (inner, res.obs, rew_acc, done_acc), res

        B = self.rl_games_batch
        init = (state.inner, state.last_obs, jnp.zeros(B, jnp.float32),
                jnp.zeros(B, jnp.int32))
        (inner, obs, rew, done), results = jax.lax.scan(
            body, init, None, length=self.llc_steps)
        last = jax.tree.map(lambda x: x[-1], results)
        res = last._replace(rew=rew / self.llc_steps, reset=done, obs=obs)
        return HRLEnvState(inner=inner, last_obs=obs), res


def build_llc_from_checkpoint(task, llc_config: dict,
                              checkpoint_path: Optional[str] = None,
                              key=None):
    """Construct the frozen LLC (ref _build_llc :116-128): network from the
    llc train config; weights from the checkpoint when given, else fresh
    (for tests / before a low-level AMP run exists)."""
    latent_dim = int(llc_config.get("latent_dim", 64))
    units = tuple(llc_config.get("units", [1024, 512]))
    net = LatentConditionedActor(task.num_actions, units)
    if key is None:
        key = jax.random.PRNGKey(0)
    params = net.init(key, jnp.zeros((1, task.num_obs)),
                      jnp.zeros((1, latent_dim)))
    if checkpoint_path:
        from .checkpoint import load_checkpoint
        params = load_checkpoint(checkpoint_path, params)
    return net.apply, params, latent_dim
