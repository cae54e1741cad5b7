"""AMP agent — adversarial motion priors (reference learning/amp_continuous.py
555 LoC + amp_network_builder/amp_models/amp_datasets/replay_buffer).

Extends the PPO learner with a style discriminator:
* demo transitions from the MotionLib (``_update_amp_demos`` :183 ->
  ``fetch_amp_obs_demo``), a replay buffer of past agent transitions
  (replay_buffer.py:32-110), and fresh agent transitions feed the
  discriminator each epoch (:171-247),
* discriminator reward ``-log(max(1 - sigmoid(D), eps))`` scaled by
  ``disc_reward_scale`` (:498-511), combined with the task reward as
  ``task_reward_w * r_task + disc_reward_w * r_disc`` (:488-496),
* disc losses: BCE (demo 1 / agent 0) + R1 gradient penalty on demo obs +
  logit weight decay (:393-440),
* AMP-observation running normalization shared by all disc inputs.

Everything is folded into the single jitted ``train_epoch`` via the PPO
hooks (``_collect_aux`` / ``_transform_rewards``) plus a disc phase.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from . import nn
from .ppo import PPOAgent, PPOState, Rollout
from .running_norm import RunningMeanStd


@dataclass(frozen=True)
class Discriminator(nn.Module):
    """MLP + logit head (amp_network_builder.py:93-117)."""

    units: tuple = (1024, 512)

    def __call__(self, scope, amp_obs):
        x = nn.mlp(scope.child("disc_mlp"), amp_obs, self.units, "relu")
        return nn.dense(scope.child("disc_logits"), x, 1,
                        kernel_init=nn.uniform(1.0)).squeeze(-1)


class AMPVars(NamedTuple):
    disc_params: Any
    disc_opt: Any
    amp_rms: RunningMeanStd
    replay: jax.Array          # (replay_size, amp_dim) ring buffer
    replay_n: jax.Array        # scalar count
    key: jax.Array


class AMPState(NamedTuple):
    ppo: PPOState
    amp: AMPVars

    # train.py's checkpoint/video/play paths address the inner PPO fields
    # uniformly across agents (state.env_state / state.last_obs /
    # state.params / state.obs_rms) — forward them so the AMP wrapper is a
    # drop-in PPOState on those surfaces
    @property
    def env_state(self):
        return self.ppo.env_state

    @property
    def last_obs(self):
        return self.ppo.last_obs

    @property
    def params(self):
        return self.ppo.params

    @property
    def obs_rms(self):
        return self.ppo.obs_rms


class AMPAgent(PPOAgent):
    def __init__(self, task, train_cfg: dict, seed: int = 42):
        super().__init__(task, train_cfg, seed)
        c = train_cfg["params"]["config"]
        self.task_reward_w = float(c.get("task_reward_w", 0.0))
        self.disc_reward_w = float(c.get("disc_reward_w", 0.5))
        self.disc_reward_scale = float(c.get("amp_disc_reward_scale",
                                             c.get("disc_reward_scale", 2.0)))
        self.disc_coef = float(c.get("disc_coef", 5.0))
        self.disc_grad_penalty = float(c.get("disc_grad_penalty", 5.0))
        self.disc_logit_reg = float(c.get("disc_logit_reg", 0.05))
        self.disc_lr = float(c.get("learning_rate", 5e-5))
        self.amp_batch = int(c.get("amp_batch_size", 512))
        self.replay_size = int(c.get("amp_replay_buffer_size", 100_000)) \
            // max(self.task.num_amp_obs // 64, 1)
        self.replay_size = max(4096, min(self.replay_size, 65536))
        self.amp_dim = task.num_amp_obs
        self.disc = Discriminator(
            tuple(train_cfg["params"]["network"].get(
                "mlp", {}).get("units", [1024, 512])))
        self._disc_optim = optax.adam(self.disc_lr)
        self.train_epoch = jax.jit(self._train_epoch_amp)

    # ------------------------------------------------------------------
    def init(self, key: Optional[jax.Array] = None) -> AMPState:
        ppo = super().init(key)
        k1, k2 = jax.random.split(ppo.key)
        ppo = ppo._replace(key=k1)
        disc_params = self.disc.init(k2, jnp.zeros((1, self.amp_dim)))
        return AMPState(
            ppo=ppo,
            amp=AMPVars(
                disc_params=disc_params,
                disc_opt=self._disc_optim.init(disc_params),
                amp_rms=RunningMeanStd.create((self.amp_dim,)),
                replay=jnp.zeros((self.replay_size, self.amp_dim), jnp.float32),
                replay_n=jnp.asarray(0, jnp.int32),
                key=k2,
            ))

    # PPO hooks -----------------------------------------------------------
    def _collect_aux(self, res):
        return res.extras["amp_obs"]

    def _transform_rewards(self, state: PPOState, roll: Rollout) -> Rollout:
        """Combine task + discriminator rewards (_combine_rewards :488-511)."""
        amp = self._amp_vars
        amp_obs_n = amp.amp_rms.normalize(roll.aux)
        logits = self.disc.apply(amp.disc_params, amp_obs_n)
        prob = jax.nn.sigmoid(logits)
        disc_r = -jnp.log(jnp.maximum(1.0 - prob, 1e-4)) * self.disc_reward_scale
        combined = self.task_reward_w * roll.rewards + self.disc_reward_w * disc_r
        return roll._replace(rewards=combined)

    # ------------------------------------------------------------------
    def _disc_loss(self, disc_params, agent_obs, demo_obs):
        """(amp_continuous.py:393-440)."""
        agent_logits = self.disc.apply(disc_params, agent_obs)
        demo_fn = lambda x: self.disc.apply(disc_params, x)
        demo_logits = demo_fn(demo_obs)
        loss_agent = jnp.mean(jax.nn.softplus(agent_logits))      # BCE vs 0
        loss_demo = jnp.mean(jax.nn.softplus(-demo_logits))       # BCE vs 1
        bce = 0.5 * (loss_agent + loss_demo)
        # R1 gradient penalty on demo observations
        grad = jax.vmap(jax.grad(lambda x: demo_fn(x[None])[0]))(demo_obs)
        gp = jnp.mean(jnp.sum(jnp.square(grad), axis=-1))
        # logit weight decay
        logit_w = disc_params["params"]["disc_logits"]["kernel"]
        reg = jnp.sum(jnp.square(logit_w))
        loss = bce + self.disc_grad_penalty * gp + self.disc_logit_reg * reg
        acc_agent = jnp.mean((agent_logits < 0).astype(jnp.float32))
        acc_demo = jnp.mean((demo_logits > 0).astype(jnp.float32))
        return loss, (bce, gp, acc_agent, acc_demo)

    def _train_epoch_amp(self, state: AMPState):
        amp = state.amp
        self._amp_vars = amp  # visible to the _transform_rewards hook
        ppo, metrics = self._train_epoch(state.ppo)

        # ---- discriminator phase (train_epoch :171-247)
        key, k_demo, k_replay, k_mb = jax.random.split(amp.key, 4)
        # agent amp obs from this epoch's rollout were consumed inside the
        # hook; re-collect from the env extras stored during rollout is not
        # possible post-hoc, so the hook stashes them:
        agent_obs = self._last_amp_obs.reshape(-1, self.amp_dim)
        n_agent = agent_obs.shape[0]

        demo_obs = self.task.fetch_amp_obs_demo(k_demo, self.amp_batch)
        # mix agent obs with replay samples (amp_continuous.py:225-247)
        have = jnp.maximum(amp.replay_n, 1)
        ridx = jax.random.randint(k_replay, (self.amp_batch,), 0,
                                  jnp.minimum(have, self.replay_size))
        replay_obs = amp.replay[ridx]
        use_replay = (amp.replay_n > self.amp_batch)
        aidx = jax.random.randint(k_mb, (self.amp_batch,), 0, n_agent)
        agent_batch = agent_obs[aidx]
        agent_mix = jnp.where(use_replay,
                              jnp.concatenate([agent_batch[: self.amp_batch // 2],
                                               replay_obs[: self.amp_batch // 2]]),
                              agent_batch)

        rms = amp.amp_rms.update(agent_obs)
        agent_n = rms.normalize(agent_mix)
        demo_n = rms.normalize(demo_obs)
        (dloss, (bce, gp, acc_a, acc_d)), grads = jax.value_and_grad(
            self._disc_loss, has_aux=True)(amp.disc_params, agent_n, demo_n)
        updates, disc_opt = self._disc_optim.update(grads, amp.disc_opt,
                                                    amp.disc_params)
        disc_params = optax.apply_updates(amp.disc_params, updates)

        # replay store (ring)
        store = agent_batch
        idx = (amp.replay_n + jnp.arange(store.shape[0])) % self.replay_size
        replay = amp.replay.at[idx].set(store)
        replay_n = amp.replay_n + store.shape[0]

        metrics = dict(metrics)
        metrics.update({"disc_loss": dloss, "disc_bce": bce,
                        "disc_grad_penalty": gp, "disc_acc_agent": acc_a,
                        "disc_acc_demo": acc_d})
        new_amp = AMPVars(disc_params=disc_params, disc_opt=disc_opt,
                          amp_rms=rms, replay=replay, replay_n=replay_n,
                          key=key)
        return AMPState(ppo=ppo, amp=new_amp), metrics

    # stash rollout amp obs for the disc phase
    def _rollout(self, state):
        state, roll, last_obs, stats = super()._rollout(state)
        self._last_amp_obs = roll.aux
        return state, roll, last_obs, stats
