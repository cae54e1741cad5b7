"""CLI entry point (reference train.py): ``python -m isaacgymenvs_ma_tpu.train
task=Ant num_envs=4096 train.params.config.max_epochs=500 ...``.

Hydra-grammar dotted overrides on the same config surfaces as the reference
(global flags from cfg/config.yaml, ``task.*`` -> cfg/task/<T>.yaml,
``train.*`` -> cfg/train/<T>PPO.yaml).  ``test=True checkpoint=...`` runs the
player path; ``multi_gpu``/host sharding happens automatically over all
visible devices (the torchrun/DDP replacement — SURVEY.md §2.6).
"""
from __future__ import annotations

import os
import sys
from datetime import datetime

import jax


def _split_overrides(argv):
    global_ov, task_ov, train_ov = [], [], []
    for a in argv:
        if "=" not in a:
            continue
        key = a.lstrip("+")
        if key.startswith("task."):
            task_ov.append(a.split(".", 1)[1])
        elif key.startswith("train."):
            train_ov.append(a.split(".", 1)[1])
        else:
            global_ov.append(a)
    return global_ov, task_ov, train_ov


def launch(argv=None):
    from .learning.configs import train_default_config  # noqa: F401
    from .learning.ppo import PPOAgent
    from .learning import checkpoint as ckpt
    from .parallel import mesh as pmesh
    from .tasks import registry
    from .utils.config import (GLOBAL_DEFAULTS, apply_overrides,
                               load_task_config, load_train_config,
                               resolve_default, print_dict)
    from .utils.observers import (MultiObserver, TensorboardObserver,
                                  WandbObserver)
    from .ops.rng import make_seed
    from .utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    global_ov, task_ov, train_ov = _split_overrides(argv)
    cfg = apply_overrides(dict(GLOBAL_DEFAULTS), global_ov)

    # multi-host: the torchrun/DDP analog (reference README:165-172,
    # rlgames_utils.py:89-107).  Coordinator/rank discovery comes from the
    # cluster env (JAX_COORDINATOR_ADDRESS etc.); single-process runs skip.
    if cfg.get("multi_gpu"):
        try:
            jax.distributed.initialize()
            print(f"jax.distributed: process {jax.process_index()}/"
                  f"{jax.process_count()}")
        except Exception as e:  # single-host fallback keeps working
            print(f"jax.distributed.initialize skipped: {e}")

    task_name = cfg.get("task", cfg.get("task_name", "Cartpole"))
    if isinstance(task_name, dict):
        task_name = task_name.get("name", "Cartpole")
    if cfg.get("num_envs"):
        task_ov = [f"env.numEnvs={cfg['num_envs']}"] + task_ov
    task_cfg = load_task_config(task_name, task_ov)
    # train=<Name> selects a named train config (the reference's
    # ``train: ${task}PPO`` Hydra default with CLI override, e.g.
    # train=ShadowHandPPOLSTM or train=AnymalTerrainPPO_LSTM)
    train_name = cfg.get("train")
    if not isinstance(train_name, str) or not train_name:
        train_name = task_name
    train_cfg = load_train_config(train_name, train_ov)
    if cfg.get("max_iterations"):
        train_cfg["params"]["config"]["max_epochs"] = int(cfg["max_iterations"])

    # PBT: first-launch mutation restart (reference train.py:88-89)
    if (cfg.get("pbt") or {}).get("enabled"):
        from .pbt import initial_pbt_check
        initial_pbt_check(cfg)

    seed = make_seed(int(cfg.get("seed", 42)),
                     rank=jax.process_index(),
                     deterministic=bool(cfg.get("torch_deterministic", False)))

    print(f"task: {task_name}  envs: {task_cfg['env']['numEnvs']}  seed: {seed}  "
          f"devices: {jax.device_count()}")
    task = registry.create_task(task_name, task_cfg, seed=seed,
                                headless=bool(cfg.get("headless", True)))
    algo = train_cfg["params"]["algo"]["name"]
    if algo == "amp_continuous":
        from .learning.amp import AMPAgent
        agent = AMPAgent(task, train_cfg, seed=seed)
    elif algo == "sac":
        from .learning.sac import SACAgent
        agent = SACAgent(task, train_cfg, seed=seed)
    else:
        # a2c_continuous and a2c_continuous_MA share the core; MA episode
        # striding is driven by the env's num_agents (A2CAgent_MA.py:44-47)
        agent = PPOAgent(task, train_cfg, seed=seed)

    exp_name = resolve_default(
        train_cfg["params"]["config"].get("name", task_name),
        cfg.get("experiment"))
    run_dir = os.path.join("runs", f"{exp_name}_{datetime.now():%d-%H-%M-%S}")
    nn_dir = os.path.join(run_dir, "nn")

    # per-run config snapshot (reference train.py:204-210)
    if jax.process_index() == 0:
        os.makedirs(run_dir, exist_ok=True)
        import json
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump({"global": cfg, "task": task_cfg, "train": train_cfg},
                      f, indent=1, default=repr)

    observers = [TensorboardObserver(os.path.join(run_dir, "summaries"))]
    if cfg.get("wandb_activate") and jax.process_index() == 0:
        observers.append(WandbObserver(
            project=cfg.get("wandb_project", "isaacgymenvs_ma_tpu"),
            group=cfg.get("wandb_group", ""), name=cfg.get("wandb_name", exp_name),
            entity=cfg.get("wandb_entity", ""), tags=cfg.get("wandb_tags", [])))
    pbt_observer = None
    if (cfg.get("pbt") or {}).get("enabled"):
        from .pbt import PbtAlgoObserver
        from .learning import checkpoint as _ck
        pbt_observer = "placeholder"  # constructed after state init below
    observer = MultiObserver(*observers)

    state = agent.init()
    if jax.device_count() > 1:
        m = pmesh.make_mesh()
        state = pmesh.shard_batch_pytree(
            state, m, batch_sizes=(task.num_envs, task.rl_games_batch))
        # the mesh in context lets per-shard kernels (physics/fk_kernel.py)
        # run under shard_map instead of on the gathered batch
        jax.sharding.set_mesh(m)

    if cfg.get("checkpoint"):
        state, env_extra, meta = ckpt.load_checkpoint(cfg["checkpoint"], state)
        print(f"restored checkpoint {cfg['checkpoint']} (meta {meta})")
        if cfg.get("sigma") not in ("", None):
            # fixed exploration sigma at restore (reference train.py:212-216
            # runner.run({'sigma': ...}))
            import numpy as np
            import jax.numpy as jnp
            from jax import tree_util as jtu
            sig = np.log(float(cfg["sigma"]))

            def _set(path, leaf):
                if any(getattr(p, "key", None) == "log_sigma"
                       for p in path):
                    return jnp.full_like(leaf, sig)
                return leaf
            state = state._replace(
                params=jtu.tree_map_with_path(_set, state.params))
            print(f"sigma overridden to {float(cfg['sigma'])}")

    if pbt_observer is not None:
        from .pbt import PbtAlgoObserver

        class _StateRef:
            cur = state
        self_ref = _StateRef()

        def _save(path):
            ckpt.save_checkpoint(path, self_ref.cur)

        def _restore(path):
            self_ref.cur, _, _ = ckpt.load_checkpoint(path, self_ref.cur)
        pbt_observer = PbtAlgoObserver(cfg, train_cfg, _save, _restore)
        _pbt_state_ref = self_ref
    else:
        _pbt_state_ref = None

    if cfg.get("test"):
        return _play(task, agent, state, cfg, run_dir=run_dir)

    # periodic policy videos (reference capture_video / RecordVideo wrapper,
    # train.py:138-145).  The training rollout is one XLA program, so frames
    # are captured on short side rollouts every capture_video_freq per-env
    # steps rather than inside the hot loop.
    video = None
    if cfg.get("capture_video") and jax.process_index() == 0:
        video = (int(cfg.get("capture_video_freq", 1464)),
                 int(cfg.get("capture_video_len", 100)), [0])

    pcfg = agent.cfg
    save_freq = pcfg.save_frequency
    max_epochs = pcfg.max_epochs
    import time
    t0 = time.time()
    for ep in range(1, max_epochs + 1):
        state, metrics = agent.train_epoch(state)
        if video is not None:
            freq, vlen, last = video
            env_steps = int(metrics["frames"]) // max(task.num_envs, 1)
            if env_steps // freq > last[0]:
                last[0] = env_steps // freq
                p = _capture_rollout(task, agent, state, vlen, os.path.join(
                    run_dir, "videos", f"step_{env_steps}.mp4"))
                print(f"captured video {p}")
        if _pbt_state_ref is not None:
            _pbt_state_ref.cur = state
            m_host = {k: float(v) for k, v in metrics.items()}
            pbt_observer.after_steps(ep, int(m_host["frames"]), m_host)
        if ep % int(cfg.get("log_interval", 20) or 20) == 0 or ep == max_epochs:
            m = {k: float(v) for k, v in metrics.items()}
            fps = m["frames"] / max(time.time() - t0, 1e-9)
            succ = ""
            for sk in ("episode/consecutive_successes", "episode/successes"):
                if sk in m:
                    succ = f" succ {m[sk]:.2f}"
                    break
            # task-objective diagnostics that make plateaus interpretable
            for sk, lbl in (("episode/episode/coverage", "cov"),
                            ("episode/episode/rot_dist", "rot"),
                            ("episode/episode/terrain_level", "lvl"),
                            ("episode/episode/lvl_slope", "slp"),
                            ("episode/episode/lvl_rough", "rgh"),
                            ("episode/episode/lvl_stairs", "str"),
                            ("episode/episode/lvl_discrete", "dsc"),
                            ("episode/episode/lvl_stones", "stn"),
                            ("episode/adr_npd", "npd"),
                            ("episode/engagement_depth", "dep"),
                            ("episode/curr_max_disp", "disp"),
                            ("episode/episode/fsm_mean", "fsm"),
                            ("sigma", "sig")):
                if m.get(sk) is not None:
                    succ += f" {lbl} {m[sk]:.2f}"
            print(f"epoch {ep}/{max_epochs} reward {m['mean_return']:.2f} "
                  f"len {m['mean_length']:.0f} loss {m['loss']:.4f} "
                  f"kl {m['kl']:.4f}{succ} fps {fps:,.0f}")
            observer.after_print_stats(ep, m)
            if m["mean_return"] >= pcfg.score_to_win:
                print("score_to_win reached")
                break
        if save_freq and ep % save_freq == 0 and jax.process_index() == 0:
            ckpt.save_checkpoint(
                os.path.join(nn_dir, f"{exp_name}.ckpt"), state,
                env_state_extra=task.get_env_state(state.env_state),
                meta={"epoch": ep})
    if jax.process_index() == 0:
        ckpt.save_checkpoint(os.path.join(nn_dir, f"{exp_name}.ckpt"), state,
                             env_state_extra=task.get_env_state(state.env_state),
                             meta={"epoch": max_epochs})
        print(f"saved {os.path.join(nn_dir, exp_name + '.ckpt')}")
    return state


def _capture_rollout(task, agent, state, n_steps, out_path):
    """Deterministic side rollout of env 0 -> mp4/PNG frames."""
    from .utils.viewer import FrameRecorder
    rec = FrameRecorder(task)
    env_state = state.env_state
    obs = state.last_obs

    @jax.jit
    def step(env_state, obs):
        actions = agent.act(state, obs, deterministic=True)
        env_state, res = task.step(env_state, actions)
        return env_state, res.obs

    for _ in range(n_steps):
        rec.capture(env_state)
        env_state, obs = step(env_state, obs)
    return rec.save_video(out_path)


def _play(task, agent, state, cfg, num_steps: int = 2000, run_dir="runs"):
    """Inference loop (rl_games player path — reference train.py:212-217 with
    {'play': True}; learning/common_player.py:54-152)."""
    import jax.numpy as jnp

    env_state = state.env_state
    obs = state.last_obs

    rec = None
    if cfg.get("capture_video"):
        from .utils.viewer import FrameRecorder
        rec = FrameRecorder(task)
        vlen = int(cfg.get("capture_video_len", 100))

    viewer = None
    if not cfg.get("headless", True):
        # reference play mode with a viewer window (vec_task.py:271-300):
        # ESC quits, V toggles sync, R records frames
        from .utils.viewer import InteractiveViewer
        viewer = InteractiveViewer(task)

    @jax.jit
    def step(env_state, obs):
        actions = agent.act(state, obs, deterministic=True)
        env_state, res = task.step(env_state, actions)
        return env_state, res.obs, res.rew, res.reset

    total_rew = 0.0
    games = 0
    for i in range(num_steps):
        if rec is not None and i < vlen:
            rec.capture(env_state)
        if viewer is not None:
            if not viewer.open:
                break
            viewer.render(env_state)
        env_state, obs, rew, reset = step(env_state, obs)
        total_rew += float(rew.mean())
        games += int(jnp.sum(reset))
        if (i + 1) % 200 == 0:
            print(f"step {i+1}: mean step reward {total_rew/(i+1):.3f}, "
                  f"episodes finished {games}")
    if rec is not None:
        p = rec.save_video(os.path.join(run_dir, "videos", "play.mp4"))
        print(f"captured video {p}")
    return state


if __name__ == "__main__":
    launch()
