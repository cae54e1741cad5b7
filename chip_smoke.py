"""Proof that isaacgymenvs_ma_tpu runs on an NVIDIA GPU, through the entry
points a user calls.

    python chip_smoke.py           # one card: phases 1-5 below
    python chip_smoke.py --multi   # four cards: data-parallel PPO epoch only

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit, the JAX version and devices.
   Anything but a GPU is refused; there is no CPU fallback.
2. Kernel parity: ``spd_inverse`` on real joint-space inertias of Ant,
   ShadowHand and FactoryTaskNutBoltPick against float64 NumPy, and the
   fused FK kernel (Pallas, Triton route) against the XLA reference at
   Ant@4096 and ShadowHand@16384, with both timed on the card.
3. Step parity: one ``task.step`` on the GPU against the same step on the
   in-process CPU backend, for six tasks; then 200 Ant@4096 steps on the GPU
   must stay finite.
4. Training: a 3-epoch Ant@4096 PPO run through ``train.launch``, its
   checkpoint restored by a play run through ``train.launch``.
5. Throughput (information only): Ant@4096 env-steps/s and compile seconds.

``--multi`` runs one Ant PPO ``train_epoch`` over a 4-card mesh at 4x4096
envs and the same global batch on one card from the same seed, and compares
them.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# step-parity tasks: the reference's canonical locomotion batch, then one
# task per mechanism (implicit PD drives, dense hand contacts, heightfield
# terrain, the fork's agent-folded multi-arm batch, mesh-SDF contacts)
PARITY_TASKS = (("Ant", 4096), ("BallBalance", 1024), ("ShadowHand", 1024),
                ("AnymalTerrain", 1024), ("FrankaReachMA", 512),
                ("FactoryTaskNutBoltPick", 1024))
# GPU vs CPU after one control step: per env (row), max|gpu - cpu| /
# (1 + max|cpu|) over the quantity.  Both run float32; they differ in
# reduction order and in the contact solver's products, which run at
# DEFAULT precision (TF32 on the GPU).  A contact within rounding of its
# activation threshold can switch on in one backend only, so the bound
# holds for 99% of envs; every value must be finite.
STEP_TOL = {"q": 1e-4, "qd": 2e-2, "obs": 2e-2, "rew": 2e-2}
STEP_QUANTILE = 0.99
INVERSE_TASKS = (("Ant", 4096), ("ShadowHand", 16384),
                 ("FactoryTaskNutBoltPick", 1024))
# float32 inverse of an SPD matrix: |X - H^-1| <= c * cond(H) * eps * |H^-1|
INV_C = 64.0
FK_TASKS = (("Ant", 4096), ("ShadowHand", 16384))
# FK kernel vs XLA: the same float32 formulas in another evaluation order;
# positions are O(1 m), quaternions and motion columns O(1)
FK_TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def card():
    import bench
    return bench.card()


def make_task(name, num_envs, seed=0):
    import isaacgymenvs_ma_tpu as ig
    return ig.make(seed=seed, task=name, num_envs=num_envs)


# ----------------------------------------------------------------- phase 1
def device_phase():
    """Print the card and JAX's devices; refuse anything but a GPU."""
    import jax
    log(f"card: {card()}")
    log(f"jax {jax.__version__}; devices: {jax.devices()}")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
    return dev


# ----------------------------------------------------------------- phase 2
def joint_inertia(task):
    """H = M(q) + the implicit drive/damping diagonal, at the task's reset
    state (the matrix the engine inverts each substep)."""
    import jax
    import jax.numpy as jnp
    eng = task.engine
    q = task.initial_state(jax.random.PRNGKey(0)).sim.q

    def mass(q):
        bx, bq = eng.fk(q)
        S = eng.dof_motion(bx, bq)
        I_O, _ = eng.spatial_inertia(bx, bq)
        return eng.mass_matrix(S, I_O)
    from isaacgymenvs_ma_tpu.models import model as md
    h = eng.h
    kp = np.where(eng.dof_drive_mode == md.DRIVE_POS,
                  np.asarray(eng.dof_stiffness), 0.0)
    kd = np.where(eng.dof_drive_mode != md.DRIVE_NONE,
                  np.asarray(eng.dof_drive_damping), 0.0)
    diag = (np.asarray(eng.dof_armature)
            + h * (np.asarray(eng.dof_damping) + kd)
            + h * h * (np.asarray(eng.dof_spring) + kp))
    return jax.jit(mass)(q) + jnp.asarray(np.diag(diag), jnp.float32)


def inverse_phase():
    import jax
    from isaacgymenvs_ma_tpu.physics.engine import spd_inverse
    eps = np.finfo(np.float32).eps
    for name, n in INVERSE_TASKS:
        H = joint_inertia(make_task(name, n))
        Hinv = np.asarray(jax.jit(spd_inverse)(H), np.float64)
        H64 = np.asarray(H, np.float64)
        ref = np.linalg.inv(H64)
        ev = np.linalg.eigvalsh(H64)
        cond = ev[:, -1] / ev[:, 0]
        err = (np.abs(Hinv - ref).max(axis=(1, 2))
               / np.abs(ref).max(axis=(1, 2)))
        ratio = err / (INV_C * cond * eps)
        log(f"inverse {name}: {H.shape}, worst rel err {err.max():.3e}, "
            f"max cond {cond.max():.3e}, worst err / (64 cond eps) "
            f"{ratio.max():.3f} (must be <= 1)")
        if not (np.all(np.isfinite(Hinv)) and ratio.max() <= 1.0
                and ev.min() > 0):
            raise SystemExit(f"inverse parity failed on {name}")


def _time_us(f, x, reps=50):
    import jax
    jax.block_until_ready(f(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        y = f(x)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / reps * 1e6


def fk_kernel_phase():
    import jax
    from isaacgymenvs_ma_tpu.physics import fk_kernel as fk
    for name, n in FK_TASKS:
        task = make_task(name, n)
        eng = task.engine
        q = task.initial_state(jax.random.PRNGKey(1)).sim.q
        q = q + 0.2 * jax.random.normal(jax.random.PRNGKey(2), q.shape)
        kern = jax.jit(lambda q: fk.fk_motion_kernel(eng, q))
        ref = jax.jit(lambda q: fk.fk_motion_xla(eng, q))
        err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for a, b in zip(kern(q), ref(q)))
        log(f"fk kernel {name}@{n}: max abs err {err:.2e} (tol {FK_TOL:.0e}); "
            f"kernel {_time_us(kern, q):.1f} us vs XLA {_time_us(ref, q):.1f} "
            f"us (information only)")
        if not err <= FK_TOL:
            raise SystemExit(f"fk kernel parity failed on {name}")


# ----------------------------------------------------------------- phase 3
def _rel(a, b):
    """(quantile over rows, max over rows) of the per-row relative error;
    inf if the GPU value is not finite."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    if not np.all(np.isfinite(a)):
        return float("inf"), float("inf")
    row = np.abs(a - b).max(axis=1) / (1.0 + np.abs(b).max())
    return float(np.quantile(row, STEP_QUANTILE)), float(row.max())


def step_phase():
    """One step per task on both backends.  The twelve programs compile
    concurrently (XLA compiles outside the GIL), which keeps a cold run
    well inside its time limit."""
    import jax
    from concurrent.futures import ThreadPoolExecutor
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    cases = []
    for name, n in PARITY_TASKS:
        task = make_task(name, n)
        with jax.default_device(cpu):
            st_c = task.initial_state(jax.random.PRNGKey(7))
        act = np.random.default_rng(7).uniform(
            -1.0, 1.0, (task.rl_games_batch, task.num_actions)
        ).astype(np.float32)
        args = {"gpu": (jax.device_put(st_c, gpu), jax.device_put(act, gpu)),
                "cpu": (st_c, jax.device_put(act, cpu))}
        cases.append((name, n, task, args))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2 * len(cases)) as ex:
        futs = [{dev: ex.submit(lambda t=task, a=a: jax.jit(t.step).lower(
                    *a).compile()) for dev, a in args.items()}
                for _, _, task, args in cases]
        compiled = [{dev: f.result() for dev, f in fd.items()} for fd in futs]
    log(f"step programs for {len(cases)} tasks x (gpu, cpu) compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for (name, n, task, args), prog in zip(cases, compiled):
        sg, rg = prog["gpu"](*args["gpu"])
        sc, rc = prog["cpu"](*args["cpu"])
        errs = {"q": _rel(sg.sim.q, sc.sim.q), "qd": _rel(sg.sim.qd, sc.sim.qd),
                "obs": _rel(rg.obs, rc.obs), "rew": _rel(rg.rew, rc.rew)}
        log(f"step {name}@{n}: " + ", ".join(
            f"{k} p99 {v[0]:.2e} max {v[1]:.2e} (tol {STEP_TOL[k]:.0e})"
            for k, v in errs.items()))
        bad = [k for k, v in errs.items() if not v[0] <= STEP_TOL[k]]
        if bad:
            raise SystemExit(f"step parity failed on {name}: {bad}")
        if name == "Ant":
            ant_step, ant_state, ant_task = prog["gpu"], sg, task
    rng = np.random.default_rng(8)
    st = ant_state
    for _ in range(200):
        act = rng.uniform(-1.0, 1.0, (ant_task.rl_games_batch,
                                      ant_task.num_actions)).astype(np.float32)
        st, res = ant_step(st, jax.device_put(act, gpu))
    finite = all(bool(np.all(np.isfinite(np.asarray(x))))
                 for x in (st.sim.q, st.sim.qd, res.obs, res.rew))
    log(f"200 Ant@{ant_task.num_envs} steps on the GPU: finite={finite}")
    if not finite:
        raise SystemExit("Ant diverged within 200 steps")


# ----------------------------------------------------------------- phase 4
class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def _launch(args):
    from isaacgymenvs_ma_tpu.train import launch
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        state = launch(args)
    return state, buf.getvalue()


def train_phase(num_envs=4096, extra=()):
    import jax
    common = ["task=Ant", f"num_envs={num_envs}", "seed=0",
              "experiment=chip_smoke", *extra]
    t0 = time.perf_counter()
    trained, out = _launch(common + ["max_iterations=3", "log_interval=1"])
    wall = time.perf_counter() - t0
    epochs = re.findall(r"^epoch (\d+)/3 .* loss (\S+) .* fps ([\d,]+)$",
                        out, re.M)
    saved = re.findall(r"^saved (\S+)$", out, re.M)
    losses = [float(l) for _, l, _ in epochs]
    log(f"train: {len(epochs)} epoch lines, losses {losses}, "
        f"wall {wall:.1f} s (compile included)")
    if len(epochs) != 3 or not np.all(np.isfinite(losses)) or not saved:
        raise SystemExit("training through train.launch failed")
    restored, out = _launch(common + ["test=True", f"checkpoint={saved[-1]}"])
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree.leaves(trained.params), jax.tree.leaves(restored.params)))
    plays = re.findall(r"^step \d+: mean step reward (\S+),", out, re.M)
    log(f"checkpoint {saved[-1]}: restored params bitwise equal={same}; "
        f"play printed {len(plays)} progress lines")
    if not same or not plays or not np.all(np.isfinite(
            [float(p) for p in plays])):
        raise SystemExit("checkpoint round trip / play failed")


# ----------------------------------------------------------------- phase 5
def throughput_phase():
    import bench
    r = bench.ant_throughput()
    log(f"throughput Ant@4096: {r['env_steps_per_s']:.0f} env-steps/s, "
        f"compile {r['compile_s']:.1f} s, card {card()} (information only)")


# ----------------------------------------------------------------- --multi
def multi_phase(n_cards=4, envs_per_card=4096):
    import jax
    from isaacgymenvs_ma_tpu.learning.configs import train_default_config
    from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu.parallel.mesh import make_mesh, shard_batch_pytree

    if len(jax.devices()) < n_cards:
        raise SystemExit(f"--multi needs {n_cards} GPUs; JAX found "
                         f"{len(jax.devices())}")
    n = n_cards * envs_per_card
    task = make_task("Ant", n)
    agent = PPOAgent(task, train_default_config("Ant"), seed=0)
    state = agent.init()
    mesh = make_mesh(n_cards)
    sharded = shard_batch_pytree(state, mesh,
                                 batch_sizes=(n, task.rl_games_batch))
    env_leaves = [x for x in jax.tree.leaves(sharded.env_state)
                  if x.ndim and x.shape[0] == n]
    split = all(len(x.sharding.device_set) == n_cards and
                {s.data.shape[0] for s in x.addressable_shards}
                == {envs_per_card} for x in env_leaves)
    log(f"mesh {mesh.shape}: {len(env_leaves)} env-state leaves, each split "
        f"{envs_per_card} envs per card over {n_cards} cards: {split}")
    if not split:
        raise SystemExit("env state is not split over the cards")
    single = jax.device_put(state, jax.devices()[0])

    def compile_sharded():
        with jax.sharding.set_mesh(mesh):
            return agent.train_epoch.lower(sharded).compile()

    # the two programs compile concurrently (XLA compiles outside the GIL)
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        f4 = ex.submit(compile_sharded)
        f1 = ex.submit(lambda: agent.train_epoch.lower(single).compile())
        epoch4, epoch1 = f4.result(), f1.result()
    log(f"compiled both epochs in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with jax.sharding.set_mesh(mesh):
        s4, m4 = jax.block_until_ready(epoch4(sharded))
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1, m1 = jax.block_until_ready(epoch1(single))
    t1 = time.perf_counter() - t0
    l4, l1 = float(m4["loss"]), float(m1["loss"])
    p4 = np.concatenate([np.ravel(x) for x in jax.tree.leaves(s4.params)])
    p1 = np.concatenate([np.ravel(x) for x in jax.tree.leaves(s1.params)])
    p0 = np.concatenate([np.ravel(x) for x in jax.tree.leaves(state.params)])
    dp = float(np.abs(p4 - p1).max() / np.abs(p1 - p0).max())
    dl = abs(l4 - l1) / max(abs(l1), 1e-6)
    log(f"train_epoch {n_cards} cards vs 1 card at {n} envs: loss "
        f"{l4:.6f} vs {l1:.6f} (rel diff {dl:.2e}, tol 1e-2); max param "
        f"diff / max update {dp:.2e} (tol 5e-2); epoch wall "
        f"{t4:.2f} s vs {t1:.2f} s")
    # reduction order differs (per-card partial sums + all-reduce), and
    # the learner's DEFAULT-precision products run in TF32 on either side
    if not (np.isfinite(l4) and dl <= 1e-2 and dp <= 5e-2):
        raise SystemExit("4-card epoch disagrees with the 1-card epoch")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card data-parallel phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "isaacgymenvs_ma_tpu")):
        raise SystemExit("chip_smoke.py belongs in the repository root, "
                         "beside isaacgymenvs_ma_tpu/")
    sys.path.insert(0, HERE)
    from isaacgymenvs_ma_tpu.utils.compile_cache import setup_compile_cache
    log(f"compile cache: {setup_compile_cache()}")
    import jax

    t0 = time.perf_counter()
    dev = device_phase()
    if args.multi:
        multi_phase()
    else:
        inverse_phase()
        fk_kernel_phase()
        step_phase()
        train_phase()
        throughput_phase()
    log(f"smoke wall time {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
