"""Headline benchmark: Ant env-steps/s on one GPU @ 4096 envs.

Measures the full environment hot path (physics substeps + contact solve +
observation/reward kernels + masked auto-reset) under one jit, driven by a
cheap deterministic pseudo-policy so the actions depend on the observations
(prevents the compiler from hoisting anything).  Matches the reference's
canonical throughput configuration (Ant, 4096 envs, dt=1/60, 2 substeps —
cfg/task/Ant.yaml).  Prints ONE JSON line naming the device it ran on; it
refuses to run without a GPU rather than report a CPU number.

    python bench.py
"""
import json
import subprocess
import time

import jax
import jax.numpy as jnp


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def ant_throughput(num_envs: int = 4096, steps_per_iter: int = 200,
                   iters: int = 5) -> dict:
    """Env-steps/s of ``iters`` timed scans of ``steps_per_iter`` Ant steps
    after one compile-and-warm-up scan, whose wall time is returned as
    ``compile_s``."""
    from isaacgymenvs_ma_tpu.tasks.ant import Ant, TASK_CFG
    from isaacgymenvs_ma_tpu.utils.config import deep_merge

    task = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": num_envs}}))

    # fixed random projection: actions = tanh(obs @ W) — negligible cost,
    # keeps the loop data-dependent.
    key = jax.random.PRNGKey(0)
    W = jax.random.normal(key, (task.num_obs, task.num_actions)) * 0.1

    @jax.jit
    def run(state):
        def body(carry, _):
            state, obs = carry
            actions = jnp.tanh(obs @ W)
            state, res = task.step(state, actions)
            return (state, res.obs), None
        (state, obs), _ = jax.lax.scan(
            body, (state, jnp.zeros((num_envs, task.num_obs))), None,
            length=steps_per_iter)
        return state, obs

    state = task.initial_state(jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    state, obs = run(state)
    jax.block_until_ready(obs)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(iters):
        state, obs = run(state)
    jax.block_until_ready(obs)
    dt = time.perf_counter() - t0
    return {"env_steps_per_s": num_envs * steps_per_iter * iters / dt,
            "compile_s": compile_s,
            "finite": bool(jnp.all(jnp.isfinite(obs)))}


def main():
    from isaacgymenvs_ma_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    r = ant_throughput()
    print(json.dumps({
        "metric": "ant_env_steps_per_s_per_chip",
        "value": r["env_steps_per_s"],
        "unit": "env-steps/s",
        "compile_s": r["compile_s"],
        "card": card(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
