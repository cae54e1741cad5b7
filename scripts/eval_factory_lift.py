"""Score a trained FactoryTaskNutBoltPick checkpoint with the REFERENCE
success semantics.

The reference only scores lift success AFTER a scripted close-and-lift
epilogue on the final episode step (factory_task_nut_bolt_pick.py:144-203:
``_close_gripper`` + ``_lift_gripper`` run in pre-physics of the last step,
then ``_check_lift_success(height_multiple=3.0)``).  The training metric in
an earlier training log instead reported the RAW nut height with no
epilogue — i.e. "did the policy lift the nut unassisted", a strictly harder
(and differently-defined) statistic that the keypoint-only reward
(success_bonus 0.0, FactoryTaskNutBoltPick.yaml:52) never incentivizes.

This script rolls the deterministic policy through one full episode and
reports both statistics side by side, plus the sim-health early-reset rate
(tasks/base.py unhealthy -> force reset) that truncates episodes.

Usage:  JAX_PLATFORMS=cpu python scripts/eval_factory_lift.py <ckpt> [seed]
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # leave the GPU to training

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from isaacgymenvs_ma_tpu.tasks import registry
from isaacgymenvs_ma_tpu.utils.config import (load_task_config,
                                              load_train_config)
from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu.learning import checkpoint as ckpt


def main():
    path = sys.argv[1]
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 123
    task_cfg = load_task_config("FactoryTaskNutBoltPick", [])
    train_cfg = load_train_config("FactoryTaskNutBoltPick", [])
    task = registry.create_task("FactoryTaskNutBoltPick", task_cfg, seed=seed)
    agent = PPOAgent(task, train_cfg, seed=seed)
    state = agent.init()
    if path != "random":
        state, _, meta = ckpt.load_checkpoint(path, state)
        print(f"restored {path} (meta {meta})")
    else:
        print("scoring an UNTRAINED policy (baseline / sim-health probe)")

    env_state = task.initial_state(jax.random.PRNGKey(seed))
    env_state, obs = task.reset(env_state)

    @jax.jit
    def step(env_state, obs):
        actions = agent.act(state, obs, deterministic=True)
        env_state, res = task.step(env_state, actions)
        return env_state, res

    horizon = task.max_episode_length  # 100 (ref max_episode_length)
    env_state, res = step(env_state, obs)  # consumes the initial all-reset
    obs = res.obs
    early = jnp.zeros(task.num_envs, jnp.int32)
    for t in range(horizon - 1):
        env_state, res = step(env_state, obs)
        obs = res.obs
        if t < horizon - 2:
            early = early + res.reset.astype(jnp.int32)

    in_phase = env_state.progress >= horizon - 1  # survived the full episode
    n_phase = int(in_phase.sum())
    print(f"envs: {task.num_envs}  full-episode (never force-reset): "
          f"{n_phase}  early resets total: {int(early.sum())}")

    out = task.engine.forward(env_state.sim)
    nut_z = out.root_states[:, 2, 2]
    from isaacgymenvs_ma_tpu.tasks.factory import TABLE_HEIGHT, NUT_HEIGHT
    raw = (nut_z > TABLE_HEIGHT + NUT_HEIGHT * 3.0).astype(jnp.float32)

    lifted = jax.jit(task.evaluate_lift)(env_state)
    sel = in_phase.astype(jnp.float32)
    denom = jnp.maximum(sel.sum(), 1.0)
    print(f"raw lift success (no epilogue, the old logged metric): "
          f"{float((raw * sel).sum() / denom):.3f}")
    print(f"close-and-lift epilogue success (REFERENCE metric, "
          f"_check_lift_success height_multiple=3.0): "
          f"{float((lifted * sel).sum() / denom):.3f}")
    print(f"epilogue success over ALL envs (incl. mid-episode restarts): "
          f"{float(lifted.mean()):.3f}")


if __name__ == "__main__":
    main()
