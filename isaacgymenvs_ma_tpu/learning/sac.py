"""SAC learner (rl_games SAC, exercised by the reference via
cfg/train/AntSAC.yaml — SURVEY.md §2.4).

Fully-jitted soft actor-critic with the rl_games config surface: tanh-squashed
gaussian actor, twin Q critics with target networks (tau polyak), automatic
entropy temperature toward ``-num_actions`` target entropy, device-resident
ring replay buffer, ``num_seed_steps`` warmup with uniform actions.
One ``train_epoch`` = ``num_steps_per_episode`` env steps + that many gradient
updates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from . import nn
from .running_norm import RunningMeanStd


@dataclass(frozen=True)
class TanhGaussianActor(nn.Module):
    num_actions: int
    units: tuple = (256, 128, 64)
    log_std_bounds: tuple = (-5.0, 2.0)

    def __call__(self, scope, obs):
        x = nn.mlp(scope.child("actor_mlp"), obs, self.units, "relu")
        mu = nn.dense(scope.child("mu"), x, self.num_actions)
        log_std = nn.dense(scope.child("log_std"), x, self.num_actions)
        lo, hi = self.log_std_bounds
        log_std = lo + 0.5 * (hi - lo) * (jnp.tanh(log_std) + 1.0)
        return mu, log_std


@dataclass(frozen=True)
class TwinQ(nn.Module):
    units: tuple = (256, 128, 64)

    def __call__(self, scope, obs, act):
        x = jnp.concatenate([obs, act], -1)
        q1 = nn.dense(scope.child("q1_out"),
                      nn.mlp(scope.child("q1"), x, self.units, "relu"), 1)
        q2 = nn.dense(scope.child("q2_out"),
                      nn.mlp(scope.child("q2"), x, self.units, "relu"), 1)
        return q1.squeeze(-1), q2.squeeze(-1)


class SACState(NamedTuple):
    actor_params: Any
    critic_params: Any
    target_params: Any
    log_alpha: jax.Array
    actor_opt: Any
    critic_opt: Any
    alpha_opt: Any
    obs_rms: RunningMeanStd
    env_state: Any
    last_obs: jax.Array
    buffer: Any               # dict of ring arrays
    buf_n: jax.Array
    key: jax.Array
    step: jax.Array
    mean_return: jax.Array
    ep_return: jax.Array


def _sample_action(key, mu, log_std):
    std = jnp.exp(log_std)
    eps = jax.random.normal(key, mu.shape)
    pre_tanh = mu + std * eps
    act = jnp.tanh(pre_tanh)
    logp = (-0.5 * jnp.square(eps) - log_std
            - 0.5 * jnp.log(2.0 * jnp.pi)).sum(-1)
    logp -= jnp.log(jnp.maximum(1.0 - jnp.square(act), 1e-6)).sum(-1)
    return act, logp


class SACAgent:
    def __init__(self, task, train_cfg: dict, seed: int = 42):
        self.task = task
        c = train_cfg["params"]["config"]
        self.gamma = float(c.get("gamma", 0.99))
        self.tau = float(c.get("critic_tau", 0.005))
        self.batch_size = int(c.get("batch_size", 4096))
        self.replay_size = int(c.get("replay_buffer_size", 1_000_000))
        self.replay_size = min(self.replay_size, 500_000)
        self.init_alpha = float(c.get("init_alpha", 1.0))
        self.lr = float(c.get("actor_lr", c.get("learning_rate", 3e-4)))
        self.num_seed_steps = int(c.get("num_seed_steps", 5))
        self.steps_per_epoch = int(c.get("num_steps_per_episode", 8))
        self.normalize_input = bool(c.get("normalize_input", True))
        self.target_entropy = -float(task.num_actions)
        units = tuple(train_cfg["params"]["network"].get(
            "mlp", {}).get("units", [256, 128, 64]))
        self.actor = TanhGaussianActor(task.num_actions, units)
        self.critic = TwinQ(units)
        self._aopt = optax.adam(self.lr)
        self._copt = optax.adam(self.lr)
        self._alopt = optax.adam(self.lr)
        self.seed = seed
        self.train_epoch = jax.jit(self._train_epoch)

    def init(self, key: Optional[jax.Array] = None) -> SACState:
        if key is None:
            key = jax.random.PRNGKey(self.seed)
        ka, kc, ke, key = jax.random.split(key, 4)
        B, no, na = self.task.num_envs, self.task.num_obs, self.task.num_actions
        actor_params = self.actor.init(ka, jnp.zeros((1, no)))
        critic_params = self.critic.init(kc, jnp.zeros((1, no)), jnp.zeros((1, na)))
        env_state = self.task.initial_state(ke)
        env_state, obs = self.task.reset(env_state)
        R = self.replay_size
        buffer = dict(
            obs=jnp.zeros((R, no), jnp.float32),
            act=jnp.zeros((R, na), jnp.float32),
            rew=jnp.zeros((R,), jnp.float32),
            next_obs=jnp.zeros((R, no), jnp.float32),
            done=jnp.zeros((R,), jnp.float32),
        )
        return SACState(
            actor_params=actor_params, critic_params=critic_params,
            target_params=critic_params,
            log_alpha=jnp.asarray(np.log(self.init_alpha), jnp.float32),
            actor_opt=self._aopt.init(actor_params),
            critic_opt=self._copt.init(critic_params),
            alpha_opt=self._alopt.init(jnp.zeros(())),
            obs_rms=RunningMeanStd.create((no,)),
            env_state=env_state, last_obs=obs,
            buffer=buffer, buf_n=jnp.asarray(0, jnp.int32), key=key,
            step=jnp.asarray(0, jnp.int32),
            mean_return=jnp.asarray(0.0, jnp.float32),
            ep_return=jnp.zeros(self.task.rl_games_batch, jnp.float32))

    # ------------------------------------------------------------------
    def _norm(self, rms, obs):
        return rms.normalize(obs) if self.normalize_input else obs

    def _env_step(self, state: SACState):
        key, k_act = jax.random.split(state.key)
        o = self._norm(state.obs_rms, state.last_obs)
        mu, log_std = self.actor.apply(state.actor_params, o)
        act, _ = _sample_action(k_act, mu, log_std)
        rand_act = jax.random.uniform(k_act, act.shape, minval=-1.0, maxval=1.0)
        act = jnp.where(state.step < self.num_seed_steps, rand_act, act)
        env_state, res = self.task.step(state.env_state, act)
        done = (res.reset > 0).astype(jnp.float32)
        ep_ret = state.ep_return + res.rew
        finished = done > 0
        mean_return = jnp.where(
            jnp.any(finished),
            jnp.sum(jnp.where(finished, ep_ret, 0.0))
            / jnp.maximum(jnp.sum(done), 1.0),
            state.mean_return)
        ep_ret = jnp.where(finished, 0.0, ep_ret)
        # ring store
        B = act.shape[0]
        idx = (state.buf_n + jnp.arange(B)) % self.replay_size
        buf = state.buffer
        buf = dict(
            obs=buf["obs"].at[idx].set(state.last_obs),
            act=buf["act"].at[idx].set(act),
            rew=buf["rew"].at[idx].set(res.rew),
            next_obs=buf["next_obs"].at[idx].set(res.obs),
            done=buf["done"].at[idx].set(done * (1.0 - res.extras["time_outs"]
                                                 .astype(jnp.float32))),
        )
        rms = state.obs_rms.update(res.obs) if self.normalize_input \
            else state.obs_rms
        return state._replace(env_state=env_state, last_obs=res.obs, key=key,
                              buffer=buf, buf_n=state.buf_n + B,
                              step=state.step + 1, obs_rms=rms,
                              ep_return=ep_ret, mean_return=mean_return)

    def _update(self, state: SACState, key):
        k_s, k_a1, k_a2 = jax.random.split(key, 3)
        have = jnp.minimum(jnp.maximum(state.buf_n, 1), self.replay_size)
        idx = jax.random.randint(k_s, (self.batch_size,), 0, have)
        b = {k: v[idx] for k, v in state.buffer.items()}
        o = self._norm(state.obs_rms, b["obs"])
        no_ = self._norm(state.obs_rms, b["next_obs"])
        alpha = jnp.exp(state.log_alpha)

        mu_n, ls_n = self.actor.apply(state.actor_params, no_)
        next_act, next_logp = _sample_action(k_a1, mu_n, ls_n)
        tq1, tq2 = self.critic.apply(state.target_params, no_, next_act)
        target_v = jnp.minimum(tq1, tq2) - alpha * next_logp
        target_q = b["rew"] + self.gamma * (1.0 - b["done"]) * target_v
        target_q = jax.lax.stop_gradient(target_q)

        def critic_loss(cp):
            q1, q2 = self.critic.apply(cp, o, b["act"])
            return (jnp.square(q1 - target_q).mean()
                    + jnp.square(q2 - target_q).mean())
        closs, cgrads = jax.value_and_grad(critic_loss)(state.critic_params)
        cupd, copt = self._copt.update(cgrads, state.critic_opt,
                                       state.critic_params)
        critic_params = optax.apply_updates(state.critic_params, cupd)

        def actor_loss(ap):
            mu, ls = self.actor.apply(ap, o)
            act, logp = _sample_action(k_a2, mu, ls)
            q1, q2 = self.critic.apply(critic_params, o, act)
            q = jnp.minimum(q1, q2)
            return (alpha * logp - q).mean(), logp
        (aloss, logp), agrads = jax.value_and_grad(
            actor_loss, has_aux=True)(state.actor_params)
        aupd, aopt = self._aopt.update(agrads, state.actor_opt,
                                       state.actor_params)
        actor_params = optax.apply_updates(state.actor_params, aupd)

        def alpha_loss(la):
            return (jnp.exp(la) * jax.lax.stop_gradient(
                -logp - self.target_entropy)).mean()
        alloss, algrads = jax.value_and_grad(alpha_loss)(state.log_alpha)
        alupd, alopt = self._alopt.update(algrads, state.alpha_opt,
                                          state.log_alpha)
        log_alpha = optax.apply_updates(state.log_alpha, alupd)

        target_params = jax.tree.map(
            lambda t, s: (1 - self.tau) * t + self.tau * s,
            state.target_params, critic_params)
        state = state._replace(
            actor_params=actor_params, critic_params=critic_params,
            target_params=target_params, log_alpha=log_alpha,
            actor_opt=aopt, critic_opt=copt, alpha_opt=alopt)
        return state, {"critic_loss": closs, "actor_loss": aloss,
                       "alpha": jnp.exp(log_alpha)}

    def _train_epoch(self, state: SACState):
        def body(s, _):
            s = self._env_step(s)
            key, k_upd = jax.random.split(s.key)
            s = s._replace(key=key)
            s, m = jax.lax.cond(
                s.step > self.num_seed_steps,
                lambda s: self._update(s, k_upd),
                lambda s: (s, {"critic_loss": jnp.asarray(0.0),
                               "actor_loss": jnp.asarray(0.0),
                               "alpha": jnp.exp(s.log_alpha)}),
                s)
            return s, m
        state, metrics = jax.lax.scan(body, state, None,
                                      length=self.steps_per_epoch)
        metrics = jax.tree.map(lambda x: x[-1], metrics)
        metrics["mean_return"] = state.mean_return
        metrics["frames"] = state.step * self.task.rl_games_batch
        return state, metrics
