"""PPO learner — the rl_games ``a2c_continuous`` equivalent, fully jitted.

Re-implements the training semantics the reference gets from external
rl_games >= 1.6 (SURVEY.md §2.4) as one program: the entire epoch — horizon
rollout (policy forward + env step), GAE, minibatched SGD with adaptive-KL LR
— is ONE jitted function ``train_epoch``; the host loop only logs.  Matching
features:

* diagonal-gaussian actor with fixed learnable log-sigma, shared-trunk MLP
  (``params.network`` schema),
* running mean/std obs and value normalization (``normalize_input/value``),
* GAE(lambda) with the ``value_bootstrap`` timeout trick — reward +=
  gamma * V(s) * time_outs (consumed exactly like ``A2CAgent_MA.py:36-37``),
* clipped surrogate + clipped value loss + entropy + mu bounds loss,
* adaptive-KL learning rate (the 'adaptive'/'legacy' scheduler: lr /= 1.5
  above 2*kl_threshold, *= 1.5 below threshold/2, clamped to [1e-6, 1e-2]),
* reward shaper (scale_value), grad-norm truncation,
* multi-agent batch folding: the env emits ``B = num_envs * num_agents`` actor
  rows; episode stats stride by ``num_agents`` (``A2CAgent_MA.py:44-47``).

Multi-host: constructed with a mesh, the env batch is sharded over the
``env`` axis and parameters are replicated; XLA inserts the gradient psum
(the NCCL-DDP replacement — SURVEY.md §2.6).
"""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .networks import (ActorCritic, build_network, gaussian_entropy,
                       gaussian_kl, gaussian_neglogp)
from .running_norm import RunningMeanStd


class PPOConfig(NamedTuple):
    horizon_length: int = 16
    minibatch_size: int = 8192
    mini_epochs: int = 4
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    kl_threshold: float = 0.008
    e_clip: float = 0.2
    clip_value: bool = True
    critic_coef: float = 2.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 1.0
    truncate_grads: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = False
    reward_scale: float = 1.0
    reward_shift: float = 0.0
    max_epochs: int = 500
    save_frequency: int = 50
    score_to_win: float = float("inf")
    lr_schedule: str = "adaptive"  # or "fixed"

    @staticmethod
    def from_train_cfg(cfg: dict) -> "PPOConfig":
        c = cfg["params"]["config"]
        shaper = c.get("reward_shaper", {})
        return PPOConfig(
            horizon_length=int(c.get("horizon_length", 16)),
            minibatch_size=int(c.get("minibatch_size", 8192)),
            mini_epochs=int(c.get("mini_epochs", 4)),
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            learning_rate=float(c.get("learning_rate", 3e-4)),
            kl_threshold=float(c.get("kl_threshold", 0.008)),
            e_clip=float(c.get("e_clip", 0.2)),
            clip_value=bool(c.get("clip_value", True)),
            critic_coef=float(c.get("critic_coef", 2.0)),
            entropy_coef=float(c.get("entropy_coef", 0.0)),
            bounds_loss_coef=float(c.get("bounds_loss_coef", 0.0) or 0.0),
            grad_norm=float(c.get("grad_norm", 1.0)),
            truncate_grads=bool(c.get("truncate_grads", True)),
            normalize_input=bool(c.get("normalize_input", True)),
            normalize_value=bool(c.get("normalize_value", True)),
            normalize_advantage=bool(c.get("normalize_advantage", True)),
            value_bootstrap=bool(c.get("value_bootstrap", False)),
            reward_scale=float(shaper.get("scale_value", 1.0)),
            reward_shift=float(shaper.get("shift_value", 0.0)),
            max_epochs=int(c.get("max_epochs", 500)),
            save_frequency=int(c.get("save_frequency", 50)),
            score_to_win=float(c.get("score_to_win", 1e18)),
            lr_schedule=str(c.get("lr_schedule", "adaptive")),
        )


class PPOState(NamedTuple):
    params: Any
    opt_state: Any
    obs_rms: RunningMeanStd
    value_rms: RunningMeanStd
    states_rms: Any            # RunningMeanStd on privileged states, or ()
    lr: jax.Array
    env_state: Any
    last_obs: jax.Array
    last_states: Any           # (B, num_states) or ()
    carry: Any                 # LSTM (h, c) per batch row, or ()
    key: jax.Array
    epoch: jax.Array
    frames: jax.Array
    # episode trackers (per tracked env row)
    ep_return: jax.Array
    ep_length: jax.Array
    mean_return: jax.Array   # exp-smoothed mean of finished episodes
    mean_length: jax.Array


class Rollout(NamedTuple):
    obs: jax.Array
    states: Any
    carry: Any
    actions: jax.Array
    neglogp: jax.Array
    values: jax.Array
    rewards: jax.Array
    dones: jax.Array
    mu: jax.Array
    sigma: jax.Array
    aux: Any = ()          # per-step task extras (e.g. AMP observations)


class PPOAgent:
    """Trains one task.  All heavy methods are jit-compiled once."""

    def __init__(self, task, train_cfg: dict, seed: int = 42):
        self.task = task
        self.cfg = PPOConfig.from_train_cfg(train_cfg)
        # asymmetric central-value critic (rl_games central_value_config,
        # cfg/train/ShadowHandPPOAsymm.yaml:73-88)
        cvc = train_cfg["params"]["config"].get("central_value_config")
        self.use_central_value = bool(cvc) and task.num_states > 0
        if self.use_central_value:
            from .networks import AsymActorCritic
            net_cfg = train_cfg["params"]["network"]
            cv_units = tuple(cvc.get("network", {}).get("mlp", {})
                             .get("units", [256, 128]))
            space = net_cfg.get("space", {}).get("continuous", {})
            self.net = AsymActorCritic(
                num_actions=task.num_actions,
                units=tuple(net_cfg.get("mlp", {}).get("units", (256, 128, 64))),
                cv_units=cv_units,
                activation=net_cfg.get("mlp", {}).get("activation", "elu"),
                fixed_sigma=bool(space.get("fixed_sigma", True)))
        else:
            self.net = build_network(train_cfg["params"]["network"],
                                     task.num_actions)
        # rl_games rnn networks (seq_len truncated BPTT)
        rnn_cfg = train_cfg["params"]["network"].get("rnn")
        self.is_rnn = bool(rnn_cfg) and not self.use_central_value
        if self.is_rnn:
            from .networks import ActorCriticLSTM
            net_cfg = train_cfg["params"]["network"]
            space = net_cfg.get("space", {}).get("continuous", {})
            self.seq_len = int(train_cfg["params"]["config"].get("seq_len", 4))
            self.net = ActorCriticLSTM(
                num_actions=task.num_actions,
                units=tuple(net_cfg.get("mlp", {}).get("units", (256, 128, 64))),
                lstm_units=int(rnn_cfg.get("units", 256)),
                activation=net_cfg.get("mlp", {}).get("activation", "elu"),
                fixed_sigma=bool(space.get("fixed_sigma", True)))
        self.batch = task.rl_games_batch
        self.horizon = self.cfg.horizon_length
        total = self.batch * self.horizon
        assert total % self.cfg.minibatch_size == 0, (
            f"batch {total} not divisible by minibatch {self.cfg.minibatch_size}")
        self.num_minibatches = total // self.cfg.minibatch_size
        if self.is_rnn:
            assert self.horizon % self.seq_len == 0
            self.seqs_total = (self.horizon // self.seq_len) * self.batch
            self.mb_seqs = max(self.cfg.minibatch_size // self.seq_len, 1)
            self.num_minibatches = max(self.seqs_total // self.mb_seqs, 1)
        self.seed = seed
        self._optim = optax.chain(
            optax.clip_by_global_norm(self.cfg.grad_norm)
            if self.cfg.truncate_grads else optax.identity(),
            optax.scale_by_adam(eps=1e-8),
            optax.scale(-1.0),
        )
        self.train_epoch = jax.jit(self._train_epoch)

    # ------------------------------------------------------------------
    def init(self, key: Optional[jax.Array] = None) -> PPOState:
        if key is None:
            key = jax.random.PRNGKey(self.seed)
        k_net, k_env, key = jax.random.split(key, 3)
        if self.use_central_value:
            params = self.net.init(
                k_net, jnp.zeros((1, self.task.num_obs), jnp.float32),
                jnp.zeros((1, self.task.num_states), jnp.float32))
        elif self.is_rnn:
            params = self.net.init(
                k_net, jnp.zeros((1, self.task.num_obs), jnp.float32),
                self.net.initial_carry(1))
        else:
            params = self.net.init(
                k_net, jnp.zeros((1, self.task.num_obs), jnp.float32))
        env_state = self.task.initial_state(k_env)
        env_state, obs = self.task.reset(env_state)
        nt = self.batch // self.task.num_agents
        carry0 = self.net.initial_carry(self.batch) if self.is_rnn else ()
        return PPOState(
            params=params,
            opt_state=self._optim.init(params),
            obs_rms=RunningMeanStd.create((self.task.num_obs,)),
            value_rms=RunningMeanStd.create(()),
            states_rms=(RunningMeanStd.create((self.task.num_states,))
                        if self.use_central_value else ()),
            lr=jnp.asarray(self.cfg.learning_rate, jnp.float32),
            env_state=env_state,
            last_obs=obs,
            last_states=(jnp.zeros((self.batch, self.task.num_states),
                                   jnp.float32)
                         if self.use_central_value else ()),
            carry=carry0,
            key=key,
            epoch=jnp.asarray(0, jnp.int32),
            frames=jnp.asarray(0, jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
            ep_return=jnp.zeros(nt, jnp.float32),
            ep_length=jnp.zeros(nt, jnp.float32),
            mean_return=jnp.asarray(0.0, jnp.float32),
            mean_length=jnp.asarray(0.0, jnp.float32),
        )

    # ------------------------------------------------------------------
    def _policy(self, params, obs_rms, obs, states_rms=None, states=None):
        o = obs_rms.normalize(obs) if self.cfg.normalize_input else obs
        if self.use_central_value:
            st = states if states is not None else jnp.zeros(
                (obs.shape[0], self.task.num_states), obs.dtype)
            if states_rms is not None and self.cfg.normalize_input:
                st = states_rms.normalize(st)
            return self.net.apply(params, o, st)
        return self.net.apply(params, o)

    def _collect_aux(self, res):
        """Per-step rollout extras hook (AMP grabs extras['amp_obs'])."""
        return ()

    @staticmethod
    def _scalar_extras(extras):
        """Numeric task extras -> scalar means for the observer channel
        (RLGPUAlgoObserver episode aggregation, rlgames_utils.py:149-209).
        One level of nesting is flattened (extras['episode'][term])."""
        out = {}

        def add(k, v):
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    add(f"{k}/{k2}", v2)
            elif hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.number)                     and v.dtype != jnp.bool_:
                out[k] = jnp.mean(v.astype(jnp.float32))

        for k, v in extras.items():
            if k == "time_outs" or k.startswith("_"):
                continue
            add(k, v)
        return out

    def _transform_rewards(self, state: PPOState, roll: Rollout) -> Rollout:
        """Reward post-processing hook (AMP combines disc rewards here)."""
        return roll

    def _rollout(self, state: PPOState) -> Tuple[PPOState, Rollout, jax.Array, Dict]:
        cfg = self.cfg
        na = self.task.num_agents

        def step_fn(carry, _):
            env_state, obs, states_c, rnn_c, key, ep_ret, ep_len, fin = carry
            key, k_act = jax.random.split(key)
            if self.is_rnn:
                o = state.obs_rms.normalize(obs) if cfg.normalize_input else obs
                mu, log_sigma, v_norm, rnn_next = self.net.apply(
                    state.params, o, rnn_c)
            else:
                rnn_next = ()
                mu, log_sigma, v_norm = self._policy(
                    state.params, state.obs_rms, obs,
                    states_rms=state.states_rms if self.use_central_value else None,
                    states=states_c if self.use_central_value else None)
            sigma = jnp.exp(log_sigma)
            actions = mu + sigma * jax.random.normal(k_act, mu.shape)
            neglogp = gaussian_neglogp(mu, log_sigma, actions)
            value = state.value_rms.denormalize(v_norm) if cfg.normalize_value else v_norm

            env_state, res = self.task.step(env_state, actions)
            rew = cfg.reward_scale * (res.rew + cfg.reward_shift)
            if cfg.value_bootstrap:
                rew = rew + cfg.gamma * value * res.extras["time_outs"].astype(rew.dtype)
            done = (res.reset > 0)

            # episode stats stride by num_agents (A2CAgent_MA.py:44-47)
            row_rew = res.rew[::na]
            row_done = done[::na]
            ep_ret = ep_ret + row_rew
            ep_len = ep_len + 1.0
            fin_sum, fin_len, fin_cnt = fin
            fin = (fin_sum + jnp.sum(jnp.where(row_done, ep_ret, 0.0)),
                   fin_len + jnp.sum(jnp.where(row_done, ep_len, 0.0)),
                   fin_cnt + jnp.sum(row_done))
            ep_ret = jnp.where(row_done, 0.0, ep_ret)
            ep_len = jnp.where(row_done, 0.0, ep_len)

            next_states = res.states if self.use_central_value else ()
            if self.is_rnn:
                # reset hidden state at episode boundaries
                rnn_next = tuple(jnp.where(done[:, None], 0.0, x)
                                 for x in rnn_next)
            out = Rollout(obs=obs,
                          states=states_c if self.use_central_value else (),
                          carry=rnn_c if self.is_rnn else (),
                          actions=actions, neglogp=neglogp, values=value,
                          rewards=rew, dones=done, mu=mu, sigma=sigma,
                          aux=self._collect_aux(res))
            return (env_state, res.obs, next_states, rnn_next, key,
                    ep_ret, ep_len, fin), (out, self._scalar_extras(res.extras))

        fin0 = (jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0.0))
        (env_state, last_obs, last_states, last_carry, key, ep_ret, ep_len,
         fin), (roll, extra_seq) = jax.lax.scan(
            step_fn,
            (state.env_state, state.last_obs, state.last_states, state.carry,
             state.key, state.ep_return, state.ep_length, fin0),
            None, length=self.horizon)

        fin_sum, fin_len, fin_cnt = fin
        has = fin_cnt > 0
        mean_return = jnp.where(has, fin_sum / jnp.maximum(fin_cnt, 1.0),
                                state.mean_return)
        mean_length = jnp.where(has, fin_len / jnp.maximum(fin_cnt, 1.0),
                                state.mean_length)
        state = state._replace(env_state=env_state, last_obs=last_obs,
                               last_states=last_states, key=key,
                               carry=last_carry if self.is_rnn else state.carry,
                               ep_return=ep_ret, ep_length=ep_len,
                               mean_return=mean_return, mean_length=mean_length)
        stats = {"episodes_done": fin_cnt}
        for k, v in extra_seq.items():
            stats[f"episode/{k}"] = jnp.mean(v)
        return state, roll, last_obs, stats

    def _gae(self, state: PPOState, roll: Rollout, last_obs: jax.Array):
        cfg = self.cfg
        if self.is_rnn:
            o = state.obs_rms.normalize(last_obs) if cfg.normalize_input \
                else last_obs
            _, _, v_norm, _ = self.net.apply(state.params, o, state.carry)
        else:
            _, _, v_norm = self._policy(
                state.params, state.obs_rms, last_obs,
                states_rms=state.states_rms if self.use_central_value else None,
                states=state.last_states if self.use_central_value else None)
        last_value = state.value_rms.denormalize(v_norm) if cfg.normalize_value else v_norm

        def scan_fn(lastgaelam, inp):
            rew, done, value, next_value = inp
            nonterminal = 1.0 - done.astype(jnp.float32)
            delta = rew + cfg.gamma * next_value * nonterminal - value
            lastgaelam = delta + cfg.gamma * cfg.tau * nonterminal * lastgaelam
            return lastgaelam, lastgaelam

        next_values = jnp.concatenate([roll.values[1:], last_value[None]], axis=0)
        _, adv = jax.lax.scan(
            scan_fn, jnp.zeros_like(last_value),
            (roll.rewards, roll.dones, roll.values, next_values), reverse=True)
        returns = adv + roll.values
        return adv, returns

    def _loss(self, params, mb, value_rms):
        cfg = self.cfg
        (obs, states, actions, old_neglogp, old_values_n, adv, returns_n,
         old_mu, old_sigma) = mb
        if self.use_central_value:
            mu, log_sigma, v_pred_n = self.net.apply(params, obs, states)
        else:
            mu, log_sigma, v_pred_n = self.net.apply(params, obs)
        neglogp = gaussian_neglogp(mu, log_sigma, actions)
        ratio = jnp.exp(jnp.clip(old_neglogp - neglogp, -20.0, 20.0))
        surr1 = adv * ratio
        surr2 = adv * jnp.clip(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -jnp.minimum(surr1, surr2).mean()

        if cfg.clip_value:
            v_clipped = old_values_n + jnp.clip(
                v_pred_n - old_values_n, -cfg.e_clip, cfg.e_clip)
            c_loss = jnp.maximum(jnp.square(v_pred_n - returns_n),
                                 jnp.square(v_clipped - returns_n)).mean()
        else:
            c_loss = jnp.square(v_pred_n - returns_n).mean()

        entropy = gaussian_entropy(log_sigma).mean()
        b_loss = jnp.sum(
            jnp.square(jnp.maximum(mu - 1.1, 0.0))
            + jnp.square(jnp.minimum(mu + 1.1, 0.0)), axis=-1).mean()

        total = (a_loss + 0.5 * cfg.critic_coef * c_loss
                 - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss)
        kl = gaussian_kl(old_mu, jnp.log(old_sigma), mu, log_sigma).mean()
        return total, (a_loss, c_loss, entropy, kl)

    def _loss_rnn(self, params, mb, value_rms):
        """Truncated-BPTT PPO loss over (mb, L, ...) sequences."""
        cfg = self.cfg
        (obs, h0, c0, actions, old_neglogp, old_values_n, adv, returns_n,
         old_mu, old_sigma) = mb

        def fwd(carry, t):
            mu_t, ls_t, v_t, carry = self.net.apply(params, obs[:, t], carry)
            return carry, (mu_t, ls_t, v_t)

        _, (mu, log_sigma, v_pred_n) = jax.lax.scan(
            fwd, (h0, c0), jnp.arange(obs.shape[1]))
        # scan stacks over time first: (L, mb, ...) -> flatten with targets
        def tflat(x):  # (mb, L, ...) -> (L*mb, ...)
            return jnp.swapaxes(x, 0, 1).reshape((-1,) + x.shape[2:])
        mu = mu.reshape((-1,) + mu.shape[2:])
        log_sigma = log_sigma.reshape((-1,) + log_sigma.shape[2:])
        v_pred_n = v_pred_n.reshape(-1)
        actions, old_neglogp = tflat(actions), tflat(old_neglogp)
        old_values_n, adv, returns_n = tflat(old_values_n), tflat(adv), tflat(returns_n)
        old_mu, old_sigma = tflat(old_mu), tflat(old_sigma)

        neglogp = gaussian_neglogp(mu, log_sigma, actions)
        ratio = jnp.exp(jnp.clip(old_neglogp - neglogp, -20.0, 20.0))
        surr1 = adv * ratio
        surr2 = adv * jnp.clip(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -jnp.minimum(surr1, surr2).mean()
        if cfg.clip_value:
            v_clipped = old_values_n + jnp.clip(
                v_pred_n - old_values_n, -cfg.e_clip, cfg.e_clip)
            c_loss = jnp.maximum(jnp.square(v_pred_n - returns_n),
                                 jnp.square(v_clipped - returns_n)).mean()
        else:
            c_loss = jnp.square(v_pred_n - returns_n).mean()
        entropy = gaussian_entropy(log_sigma).mean()
        b_loss = jnp.sum(
            jnp.square(jnp.maximum(mu - 1.1, 0.0))
            + jnp.square(jnp.minimum(mu + 1.1, 0.0)), axis=-1).mean()
        total = (a_loss + 0.5 * cfg.critic_coef * c_loss
                 - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss)
        kl = gaussian_kl(old_mu, jnp.log(old_sigma), mu, log_sigma).mean()
        return total, (a_loss, c_loss, entropy, kl)

    def _train_epoch(self, state: PPOState):
        cfg = self.cfg
        state, roll, last_obs, stats = self._rollout(state)
        roll = self._transform_rewards(state, roll)
        adv, returns = self._gae(state, roll, last_obs)

        # flatten (T, B, ...) -> (T*B, ...)
        def flat(x):
            return x.reshape((-1,) + x.shape[2:])
        obs_f = flat(roll.obs)
        if cfg.normalize_input:
            # normalize the training batch with the SAME stats the rollout
            # policy used (old mu/neglogp consistency), then update for the
            # next epoch.
            obs_train = state.obs_rms.normalize(obs_f)
            state = state._replace(obs_rms=state.obs_rms.update(obs_f))
        else:
            obs_train = obs_f
        if cfg.normalize_value:
            value_rms = state.value_rms.update(flat(returns))
            state = state._replace(value_rms=value_rms)
            returns_n = value_rms.normalize(flat(returns), clip=1e8)
            old_values_n = value_rms.normalize(flat(roll.values), clip=1e8)
        else:
            returns_n = flat(returns)
            old_values_n = flat(roll.values)

        adv_f = flat(adv)
        if cfg.normalize_advantage:
            adv_f = (adv_f - adv_f.mean()) / (adv_f.std() + 1e-8)

        if self.use_central_value:
            states_f = flat(roll.states)
            states_train = state.states_rms.normalize(states_f) \
                if self.cfg.normalize_input else states_f
            state = state._replace(states_rms=state.states_rms.update(states_f))
        else:
            states_train = jnp.zeros((obs_train.shape[0], 0), jnp.float32)
        if self.is_rnn:
            # sequence layout for truncated BPTT: (T, B, ...) ->
            # (B * T/L, L, ...) with the stored hidden state at each
            # sequence start (rl_games seq_len semantics)
            L = self.seq_len
            S = self.horizon // L
            T, B = self.horizon, self.batch

            def seq(x):
                x2 = x.reshape((S, L, B) + x.shape[2:])
                return jnp.moveaxis(x2, 2, 0).reshape((B * S, L) + x.shape[2:])

            obs_norm_t = state.obs_rms.normalize(roll.obs) \
                if cfg.normalize_input else roll.obs
            adv_t = adv
            if cfg.normalize_advantage:
                adv_t = (adv_t - adv_t.mean()) / (adv_t.std() + 1e-8)
            rtn_t = state.value_rms.normalize(returns, clip=1e8) \
                if cfg.normalize_value else returns
            val_t = state.value_rms.normalize(roll.values, clip=1e8) \
                if cfg.normalize_value else roll.values
            carry0 = tuple(
                jnp.moveaxis(c.reshape(S, L, B, -1)[:, 0], 1, 0).reshape(B * S, -1)
                for c in roll.carry)
            data = (seq(obs_norm_t), carry0[0], carry0[1], seq(roll.actions),
                    seq(roll.neglogp), seq(val_t), seq(adv_t), seq(rtn_t),
                    seq(roll.mu), seq(roll.sigma))
            total = B * S
            mb_size = self.mb_seqs
            loss_fn = self._loss_rnn
        else:
            data = (obs_train, states_train, flat(roll.actions), flat(roll.neglogp),
                    old_values_n, adv_f, returns_n, flat(roll.mu), flat(roll.sigma))
            total = obs_f.shape[0]
            mb_size = cfg.minibatch_size
            loss_fn = self._loss

        key, k_perm = jax.random.split(state.key)

        def mini_epoch(carry, k):
            params, opt_state, lr = carry
            perm = jax.random.permutation(k, total)

            def mb_step(carry2, idx):
                params, opt_state, lr = carry2
                mb = tuple(jax.tree.map(lambda x: x[idx], d) for d in data)
                (loss, (a_l, c_l, ent, kl)), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params, mb, state.value_rms)
                updates, opt_state = self._optim.update(grads, opt_state, params)
                updates = jax.tree.map(lambda u: lr * u, updates)
                params = optax.apply_updates(params, updates)
                if cfg.lr_schedule == "adaptive":
                    lr = jnp.where(kl > 2.0 * cfg.kl_threshold,
                                   jnp.maximum(lr / 1.5, 1e-6), lr)
                    lr = jnp.where(kl < 0.5 * cfg.kl_threshold,
                                   jnp.minimum(lr * 1.5, 1e-2), lr)
                return (params, opt_state, lr), (loss, a_l, c_l, ent, kl)

            idxs = perm[: self.num_minibatches * mb_size].reshape(
                self.num_minibatches, mb_size)
            carry, metrics = jax.lax.scan(mb_step, (params, opt_state, lr), idxs)
            return carry, metrics

        keys = jax.random.split(k_perm, cfg.mini_epochs)
        (params, opt_state, lr), metrics = jax.lax.scan(
            mini_epoch, (state.params, state.opt_state, state.lr), keys)
        loss, a_l, c_l, ent, kl = jax.tree.map(jnp.mean, metrics)

        state = state._replace(
            params=params, opt_state=opt_state, lr=lr, key=key,
            epoch=state.epoch + 1,
            frames=state.frames + total)
        sig_leaves = [
            v for p, v in jax.tree_util.tree_leaves_with_path(params)
            if any(getattr(k, "key", None) == "log_sigma" for k in p)]
        out_metrics = {
            "loss": loss, "a_loss": a_l, "c_loss": c_l, "entropy": ent,
            "kl": kl, "lr": lr, "mean_return": state.mean_return,
            "mean_length": state.mean_length, "frames": state.frames,
            "episodes_done": stats["episodes_done"],
            # exploration health: mean policy stddev (a collapsing sigma is
            # how hold-still local optima lock in — allegrohand r3 forensics)
            "sigma": (jnp.exp(sig_leaves[0]).mean() if sig_leaves
                      else jnp.asarray(0.0)),
        }
        # aggregated task extras (Episode/* channel — rlgames_utils.py:149)
        out_metrics.update({k: v for k, v in stats.items()
                            if k.startswith("episode/")})
        return state, out_metrics

    # ------------------------------------------------------------------
    def train(self, max_epochs: Optional[int] = None, log_every: int = 20,
              state: Optional[PPOState] = None, observers=(),
              score_to_win: Optional[float] = None):
        """Host driver loop (the rl_games Runner.run({'train': True}) path)."""
        cfg = self.cfg
        max_epochs = max_epochs or cfg.max_epochs
        score_to_win = score_to_win if score_to_win is not None else cfg.score_to_win
        if state is None:
            state = self.init()
        t0 = time.time()
        for ep in range(max_epochs):
            state, metrics = self.train_epoch(state)
            if (ep + 1) % log_every == 0 or ep == max_epochs - 1:
                m = {k: float(v) for k, v in metrics.items()}
                fps = m["frames"] / max(time.time() - t0, 1e-9)
                print(f"epoch {ep+1}/{max_epochs} reward {m['mean_return']:.2f} "
                      f"len {m['mean_length']:.0f} kl {m['kl']:.4f} lr {m['lr']:.2e} "
                      f"fps {fps:,.0f}")
                for obv in observers:
                    obv.after_print_stats(ep + 1, m)
                if m["mean_return"] >= score_to_win:
                    print(f"score_to_win {score_to_win} reached")
                    break
        return state

    # ------------------------------------------------------------------
    def act(self, state: PPOState, obs, deterministic: bool = True, key=None):
        """Player path (PpoPlayerContinuous.get_action equivalent)."""
        mu, log_sigma, _ = self._policy(state.params, state.obs_rms, obs)
        if deterministic:
            return mu
        return mu + jnp.exp(log_sigma) * jax.random.normal(key, mu.shape)
