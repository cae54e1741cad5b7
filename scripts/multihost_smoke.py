"""Real multi-PROCESS data-parallel validation (the multi-host/DCN analog).

The reference scales multi-GPU with one torch process per device and NCCL
all-reduce inside rl_games DDP (README:165-172, ``utils/rlgames_utils.py:
89-107``).  Our design is one SPMD program over a global mesh; multi-host
just means every host calls ``jax.distributed.initialize`` and owns a slice
of the env axis (SURVEY.md §2.6/§5-comm).  Single-process tests can only
exercise the virtual 8-device mesh; THIS script validates the actual
multi-process path — global arrays assembled from per-process shards with
``jax.make_array_from_callback`` and a jitted PPO epoch whose collectives
cross process boundaries through the distributed runtime (the same program
rides ICI on a pod slice).

Usage:
    python scripts/multihost_smoke.py                 # launcher: spawns 2 workers
    python scripts/multihost_smoke.py --procs 4       # 4 workers x 2 devices

Each worker prints ``rank<k> ok loss=... digest=...``; the launcher checks
every worker exited cleanly and that the replicated parameter digests agree
bitwise across processes (gradient psum determinism).
"""
import argparse
import hashlib
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(rank: int, nprocs: int, port: int, devs_per_proc: int) -> None:
    import jax
    # distributed initialization probes platform plugins before the first
    # backend touch; pin the CPU platform through the config so an attached
    # GPU is left alone
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs, process_id=rank)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from isaacgymenvs_ma_tpu.learning.configs import train_default_config
    from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu.parallel import mesh as pmesh
    from isaacgymenvs_ma_tpu.tasks.cartpole import Cartpole, TASK_CFG
    from isaacgymenvs_ma_tpu.utils.config import deep_merge

    n_global = nprocs * devs_per_proc
    assert len(jax.devices()) == n_global, (
        f"expected {n_global} global devices, got {len(jax.devices())}")

    num_envs = 8 * n_global
    task = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": num_envs}}))
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"]["horizon_length"] = 8
    tcfg["params"]["config"]["minibatch_size"] = num_envs * 8 // 4
    agent = PPOAgent(task, tcfg, seed=0)

    mesh = pmesh.make_mesh()            # global mesh over all processes
    env_sh = NamedSharding(mesh, P(pmesh.ENV_AXIS))
    rep_sh = NamedSharding(mesh, P())
    sizes = {task.num_envs, task.rl_games_batch}

    # every process computes the same full initial state (seeded, CPU
    # deterministic), then contributes only its addressable shards — through
    # the PRODUCTION layout path (same call train.py makes), which switches
    # to jax.make_array_from_callback when process_count() > 1
    del env_sh, rep_sh, sizes
    state = agent.init()
    state = pmesh.shard_batch_pytree(
        state, mesh, batch_sizes=(task.num_envs, task.rl_games_batch))
    with jax.sharding.set_mesh(mesh):
        state, metrics = agent.train_epoch(state)
        state, metrics = agent.train_epoch(state)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), "non-finite loss"
    # ALL replicated leaves (params + optimizer state) must stay
    # bitwise-identical on every process after the cross-process gradient psum
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(state.params) + jax.tree.leaves(state.opt_state):
        h.update(np.asarray(leaf.addressable_shards[0].data).tobytes())
    digest = h.hexdigest()[:16]
    q = state.env_state.sim.q
    assert len(q.sharding.device_set) == n_global
    print(f"rank{rank} ok loss={loss:.6f} digest={digest}", flush=True)


def _launch_once(nprocs: int, devs_per_proc: int, timeout_s: int):
    """One attempt: spawn workers, collect (output, rc) per rank.  Any
    exception (incl. per-worker timeout) kills every remaining worker so
    nothing is orphaned inside a hung collective."""
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith(("XLA_FLAGS", "JAX_"))}
    procs = []
    try:
        for r in range(nprocs):
            env = dict(
                env_base,
                JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devs_per_proc}",
                MH_RANK=str(r), MH_NPROCS=str(nprocs), MH_PORT=str(port),
                MH_DEVS=str(devs_per_proc),
            )
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs, rcs = [], []
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
            rcs.append(p.returncode)
        return outs, rcs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def launch(nprocs: int, devs_per_proc: int, timeout_s: int = 240) -> int:
    # the coordinator port is probed then released (TOCTOU): retry with a
    # freshly probed port if rank0 loses the bind race
    for attempt in range(3):
        try:
            outs, rcs = _launch_once(nprocs, devs_per_proc, timeout_s)
        except subprocess.TimeoutExpired:
            print("worker timed out (all workers killed)")
            return 1
        bind_race = any("bind" in out.lower() or "address already in use"
                        in out.lower() for out, rc in zip(outs, rcs) if rc)
        if bind_race and attempt < 2:
            print("coordinator bind race, retrying with a fresh port")
            continue
        break
    ok_lines = []
    for r, (out, rc) in enumerate(zip(outs, rcs)):
        line = next((ln for ln in out.splitlines() if " ok " in ln), None)
        if rc != 0 or line is None:
            print(f"--- rank{r} FAILED (rc={rc}) ---\n{out}")
            return 1
        ok_lines.append(line)
        print(line)
    digests = {ln.split("digest=")[1] for ln in ok_lines}
    losses = {ln.split("loss=")[1].split()[0] for ln in ok_lines}
    if len(digests) != 1 or len(losses) != 1:
        print(f"MISMATCH across processes: digests={digests} losses={losses}")
        return 1
    print(f"multihost_smoke: {nprocs} processes x {devs_per_proc} devices ok "
          f"(replicated params bitwise-identical)")
    return 0


if __name__ == "__main__":
    if "MH_RANK" in os.environ:
        worker(int(os.environ["MH_RANK"]), int(os.environ["MH_NPROCS"]),
               int(os.environ["MH_PORT"]), int(os.environ["MH_DEVS"]))
    else:
        ap = argparse.ArgumentParser()
        ap.add_argument("--procs", type=int, default=2)
        ap.add_argument("--devs-per-proc", type=int, default=4)
        a = ap.parse_args()
        sys.exit(launch(a.procs, a.devs_per_proc))
