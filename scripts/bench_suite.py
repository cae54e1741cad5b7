"""Multi-task throughput suite.

Measures env-steps/s for one task family per tier of the reference's
benchmark ladder (SURVEY.md Appendix A / BASELINE.md), each at its
reference-default env count, under the same policy-coupled scan harness as
bench.py (actions = tanh(obs @ W) so the loop stays data-dependent).

Usage: python scripts/bench_suite.py [task ...]
Prints one line per task.
"""
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

# task -> (num_envs at reference default, scan length)
DEFAULT = {
    "Cartpole": (512, 200),
    "Ant": (4096, 200),
    "Humanoid": (4096, 100),
    "Anymal": (4096, 100),
    "BallBalance": (4096, 100),
    "AnymalTerrain": (4096, 50),
    "ShadowHand": (16384, 25),
    "AllegroHand": (16384, 25),
    "FrankaReachMA": (8192, 25),
    "Trifinger": (16384, 25),
    "HumanoidAMP": (4096, 50),
    # mesh-SDF tier at the reference-default 128 envs (Factory trains tiny)
    "FactoryTaskNutBoltPick": (128, 50),
    "IndustRealTaskPegsInsert": (128, 50),
    # production-batch rows (VERDICT r4 weak #6: the "scales with envs"
    # claim was never measured) — same tasks at 1024/4096 envs
    "FactoryTaskNutBoltPick@1024": (1024, 50),
    "FactoryTaskNutBoltPick@4096": (4096, 25),
    "IndustRealTaskPegsInsert@1024": (1024, 50),
}


def bench_task(name, num_envs, iters):
    from isaacgymenvs_ma_tpu.tasks import registry
    from isaacgymenvs_ma_tpu.utils.config import deep_merge

    import json, os
    label = name
    name = name.split("@")[0]   # "<Task>@<envs>" rows share the task name
    extra = json.loads(os.environ.get("BENCH_CFG", "{}"))
    cfg = deep_merge(deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": num_envs}}), extra)
    task = registry.create_task(name, cfg)
    B = task.rl_games_batch
    W = jax.random.normal(jax.random.PRNGKey(0),
                          (task.num_obs, task.num_actions)) * 0.1

    @jax.jit
    def run(state):
        def body(carry, _):
            st, obs = carry
            a = jnp.tanh(obs @ W)
            st, res = task.step(st, a)
            return (st, res.obs), None
        (st, obs), _ = jax.lax.scan(
            body, (state, jnp.zeros((B, task.num_obs))), None, length=iters)
        return st, obs

    state = task.initial_state(jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    out = run(state)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run(state)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{label:16s} envs={num_envs:6d}  {num_envs/dt/1e6:7.3f}M env-steps/s"
          f"  ({dt*1e6:8.1f} us/step, compile {compile_s:.0f}s)", flush=True)


if __name__ == "__main__":
    names = sys.argv[1:] or list(DEFAULT)
    for name in names:
        n, iters = DEFAULT.get(name, (4096, 50))
        try:
            bench_task(name, n, iters)
        except Exception as e:  # keep the sweep going; report the failure
            print(f"{name:16s} FAILED: {type(e).__name__}: {e}", flush=True)
