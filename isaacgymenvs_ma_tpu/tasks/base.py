"""Vectorized env runtime — the batched ``VecTask`` (L2).

Functional re-design of the reference's ``tasks/base/vec_task.py``:

* ``Env`` ABC responsibilities (:67-205 — spaces, env/agent/obs/action counts,
  ``numAgents`` multi-agent hook :102) live in :class:`VecTaskBase` static
  attributes.
* ``VecTask.step`` (:362-410) becomes a pure function
  ``(EnvState, actions) -> (EnvState, StepResult)`` with the exact reference
  ordering: clip actions -> pre_physics -> ``control_freq_inv x`` simulate ->
  post-physics (progress += 1; masked ``reset_idx`` of envs flagged done on the
  *previous* step, as in ``tasks/ant.py:287-293``; obs; reward) -> timeout_buf
  (:396) -> clip obs.
* Per-env heterogeneous resets (``reset_idx(env_ids)`` +
  ``set_*_tensor_indexed``) become masked ``jnp.where`` updates — resampled
  for every env, applied where ``reset_buf`` is set.
* The ``reset_buf``-initialized-to-1 protocol (:302-325) is preserved: the
  first step resets every env.
* ``reset_done()`` (:442-457, the AMP/learner-driven variant) is provided for
  the learning layer's contract (SURVEY.md Appendix B).

Everything is jit-able; the whole rollout (physics + task kernels + learner)
compiles into one XLA program.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.engine import Control, PhysicsEngine, SimOutput, SimParams, SimState


class EnvState(NamedTuple):
    sim: SimState
    progress: jax.Array          # (N,) int32
    reset_buf: jax.Array         # (N,) int32 — init 1 (vec_task.py:321)
    rng: jax.Array               # single threaded PRNG key
    task: Any = None             # task-specific pytree (potentials, targets, ...)
    phys: Any = None             # PhysScales pytree when DR is enabled


class StepResult(NamedTuple):
    obs: jax.Array               # (B, num_obs) clipped
    states: Optional[jax.Array]  # (B, num_states) asymmetric-critic states
    rew: jax.Array               # (B,)
    reset: jax.Array             # (B,) int32
    extras: Dict[str, Any]       # time_outs, episode stats, true_objective...


def parse_sim_params(sim_cfg: dict) -> SimParams:
    """Map the reference sim-config schema (vec_task.py:516-564) to SimParams."""
    physx = sim_cfg.get("physx", {})
    n_iter = int(physx.get("num_position_iterations", 4)) + int(
        physx.get("num_velocity_iterations", 0))
    import os
    return SimParams(
        dt=float(sim_cfg.get("dt", 1.0 / 60.0)),
        substeps=int(sim_cfg.get("substeps", 2)),
        gravity=tuple(sim_cfg.get("gravity", (0.0, 0.0, -9.81))),
        # explicit per-task override wins; otherwise 2x the PhysX iteration
        # budget (our Jacobi steps are weaker than TGS sub-iterations)
        num_iterations=(int(physx["num_iterations"])
                        if "num_iterations" in physx
                        else max(2 * n_iter, 8)),
        # contact warm starting (PhysX persistent-contact analog): fraction
        # of the previous substep's impulses used to seed the solve
        warm_start=float(physx.get("warm_start", 0.0)),
        max_depenetration_velocity=float(
            physx.get("max_depenetration_velocity", 10.0)),
        # speculative contact activation (PhysX contact_offset, the factory
        # yamls set 0.005) — see SimParams.contact_margin
        contact_margin=float(physx.get("contact_offset", 0.0)),
        bounce_threshold_velocity=float(
            physx.get("bounce_threshold_velocity", 0.2)),
        # reuse the mass-matrix chain across substeps (IGMA_MM_REUSE=0 opts
        # out to exact per-substep evaluation); per-task config override
        # wins (AnymalTerrain folds decimation into substeps, stretching
        # the reuse window to 20 ms — it opts out)
        reuse_mass_matrix=bool(physx.get(
            "reuse_mass_matrix",
            os.environ.get("IGMA_MM_REUSE", "1") == "1")),
        # active-set compaction capacity (our static-shape analog of
        # max_gpu_contact_pairs — per-env, not global)
        # explicit null in a config override disables compaction
        contact_capacity=(int(physx["contact_capacity"])
                          if physx.get("contact_capacity") is not None
                          else None),
        # contact rows built once per control step and reused across substeps
        # (the PhysX narrowphase-once-per-step model); default off for
        # training quality on impact-heavy locomotion, enabled per task for
        # grasping scenes via sim.physx.reuse_contact_rows (see SimParams)
        reuse_contact_rows=bool(physx.get(
            "reuse_contact_rows",
            os.environ.get("IGMA_ROW_REUSE", "0") == "1")),
        contact_continuation=bool(physx.get("contact_continuation", True)),
        # Jacobi mass splitting for dense/coincident contact clouds (mesh
        # contacts) — see SimParams.mass_splitting
        mass_splitting=bool(physx.get("mass_splitting", False)),
    )


class VecTaskBase:
    """Holds static config + compiled model; all step logic is pure."""

    dict_obs_cls = False
    # BallBalance resets in pre_physics_step (ball_balance.py:407-412)
    reset_in_pre_physics = False

    def __init__(self, cfg: dict):
        self.cfg = cfg
        # the reference selects PhysX or Flex here (vec_task.py:236-245);
        # only the PhysX-equivalent XLA engine exists — reject flex loudly
        # rather than silently running the wrong solver
        eng = str(cfg.get("physics_engine", "physx"))
        if eng not in ("physx", ""):
            raise NotImplementedError(
                f"physics_engine={eng!r} is not supported: this build "
                "implements the PhysX-equivalent rigid-body path only "
                "(SURVEY.md §2.5 — flex is out of scope)")
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.num_obs = int(env_cfg["numObservations"])
        self.num_actions = int(env_cfg["numActions"])
        self.num_states = int(env_cfg.get("numStates", 0))
        self.num_agents = int(env_cfg.get("numAgents", 1))
        self.clip_obs = float(env_cfg.get("clipObservations", np.inf))
        self.clip_actions = float(env_cfg.get("clipActions", np.inf))
        self.control_freq_inv = int(env_cfg.get("controlFrequencyInv", 1))
        self.max_episode_length = int(env_cfg.get("episodeLength", 500))
        self.sim_params = parse_sim_params(cfg.get("sim", {}))
        self.dt = self.sim_params.dt
        self.terrain = None
        task_sec = cfg.get("task", {}) or {}
        if task_sec.get("randomize"):
            from ..utils.domain_rand import DomainRandomizer
            # correlated-noise bases are per-env rows; the agent-folded MA
            # batch (N*K rows) isn't supported (no reference MA task uses DR)
            single = self.num_agents == 1
            self.randomizer = DomainRandomizer(
                task_sec.get("randomization_params", {}), self.num_envs,
                num_obs=self.num_obs if single else None,
                num_actions=self.num_actions if single else None)
        else:
            self.randomizer = None
        model, ground = self.create_model()
        self.model = model
        if self.randomizer is not None:
            self.randomizer.bind_model(model)
        self.engine = self.build_engine(model, ground)
        self.rl_games_batch = self.num_envs * self.num_agents

    # ------------------------------------------------------------------
    # hooks for concrete tasks
    def create_model(self):
        """Return (SceneModel, ground: bool). Replaces create_sim/_create_envs."""
        raise NotImplementedError

    def build_engine(self, model, ground: bool) -> PhysicsEngine:
        """Override to pass pair_specs / attractors to the engine."""
        return PhysicsEngine(model, self.sim_params, ground=ground)

    def initial_task_state(self) -> Any:
        return None

    def step_terrain(self, sim):
        """Terrain object used for this control step's physics + obs.

        Hook: AnymalTerrain swaps in a per-env LocalTerrain window so the
        heightfield lookups run as one-hot GEMMs over a small window instead
        of batched gathers from the global grid (physics/terrain.py
        local_window)."""
        return self.terrain

    def pre_physics(self, state: EnvState, actions: jax.Array) -> Control:
        raise NotImplementedError

    def post_physics(
        self, state: EnvState, out: SimOutput, actions: jax.Array
    ) -> Tuple[jax.Array, Optional[jax.Array], jax.Array, jax.Array, Any, Dict]:
        """Return (obs, states, rew, reset, task_state, extras)."""
        raise NotImplementedError

    def reset_idx(self, sim: SimState, task: Any, mask: jax.Array, key: jax.Array):
        """Masked per-env reset: return (sim', task'). ``mask`` is (N,) bool."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def initial_phys(self, key=None):
        """Per-env physics-scale pytree fed to the engine (None = nominal).
        ``key`` seeds setup-only randomization (geometry scale specs — the
        reference's setup_only actor params, domain_randomization.md)."""
        if self.randomizer is not None and self.randomizer.enabled:
            from ..utils.domain_rand import PhysScales
            if key is not None:
                return self.randomizer.initial_phys(key, self.model.nb)
            return PhysScales.ones(self.num_envs)
        return None

    def update_phys(self, state: "EnvState", reset_mask: jax.Array,
                    key: jax.Array):
        """Hook: refresh per-env physics params for resetting envs.  Default
        delegates to the DomainRandomizer (DR at reset — tasks/ant.py:252-255);
        ADR tasks override to sample from their adaptive ranges."""
        if self.randomizer is not None and state.phys is not None:
            return self.randomizer.resample_phys(key, reset_mask, state.phys)
        return state.phys

    def initial_state(self, key: jax.Array) -> EnvState:
        sim = self.engine.default_state(self.num_envs)
        phys = self.initial_phys(jax.random.fold_in(key, 17))
        return EnvState(
            sim=sim,
            progress=jnp.zeros(self.num_envs, jnp.int32),
            reset_buf=jnp.ones(self.num_envs, jnp.int32),
            rng=key,
            task=self.initial_task_state(),
            phys=phys,
        )

    def reset(self, state: EnvState):
        """Initial obs_dict (vec_task.py:428-440: no recompute, just clip)."""
        obs = jnp.zeros((self.rl_games_batch, self.num_obs), jnp.float32)
        return state, obs

    def step(self, state: EnvState, actions: jax.Array) -> Tuple[EnvState, StepResult]:
        key, k_reset, k_step, k_anoise, k_onoise, k_phys = jax.random.split(state.rng, 6)
        if self.randomizer is not None:
            # DR action noise before clipping (vec_task.py:373-376)
            actions = self.randomizer.randomize_actions(
                k_anoise, actions,
                corr=getattr(state.phys, "act_corr", None))
        actions = jnp.clip(actions, -self.clip_actions, self.clip_actions)

        reset_mask = state.reset_buf > 0
        phys = self.update_phys(state, reset_mask, k_phys)
        if phys is not state.phys:
            state = state._replace(phys=phys)
        if self.reset_in_pre_physics:
            sim, task = self.reset_idx(state.sim, state.task, reset_mask, k_reset)
            sim = self._restore_lam(sim, state.sim.lam, reset_mask)
            state = state._replace(sim=sim, task=task)

        ctrl = self.pre_physics(state, actions)
        sim = state.sim
        terrain = self.step_terrain(sim)
        out = None
        for _ in range(self.control_freq_inv):
            sim, out = self.engine.step(sim, ctrl, terrain=terrain,
                                        phys=state.phys)

        # ---- sim-health safety net ----
        # An iterative velocity-level contact solver can diverge for a few
        # envs under extreme learned gaits (PhysX's TGS has the same failure
        # mode, hidden behind its internal clamps).  Detect exploded envs,
        # sanitize their state, and force-reset them next step so one bad env
        # cannot poison the batch with unbounded rewards.
        unhealthy = (~jnp.isfinite(sim.q).all(axis=-1)
                     | ~jnp.isfinite(sim.qd).all(axis=-1)
                     | (jnp.abs(sim.qd).max(axis=-1) > 500.0))
        sim = sim._replace(
            q=jnp.where(unhealthy[:, None], jnp.nan_to_num(sim.q), sim.q),
            qd=jnp.where(unhealthy[:, None],
                         jnp.clip(jnp.nan_to_num(sim.qd), -500.0, 500.0),
                         sim.qd))

        # ---- post physics (ant.py:287-297 ordering) ----
        progress = state.progress + 1
        task = state.task
        lam_cur = sim.lam
        if not self.reset_in_pre_physics:
            sim, task = self.reset_idx(sim, task, reset_mask, k_reset)
            sim = self._restore_lam(sim, lam_cur, reset_mask | unhealthy)
        else:
            sim = self._restore_lam(sim, lam_cur, unhealthy)
        progress = jnp.where(reset_mask, 0, progress)
        # refresh readouts so reset envs observe their fresh state
        out = self.engine.forward(sim, prev_out=out)

        mid = state._replace(sim=sim, progress=progress, task=task, rng=k_step)
        obs, states, rew, reset, task, extras = self.post_physics(mid, out, actions)

        # vec_task.py:396: timeout when the episode clock (not failure) fired
        timeout = (progress >= self.max_episode_length - 1) & (reset != 0)
        extras = dict(extras)
        extras["time_outs"] = self._to_batch(timeout)
        # episode-extension hook: tasks that reset the episode clock without a
        # full env reset (AllegroKuka on success — allegro_kuka_base.py:844)
        clock_reset = extras.pop("_reset_progress_mask", None)
        if clock_reset is not None:
            progress = jnp.where(clock_reset, 0, progress)

        if self.randomizer is not None:
            # DR obs noise before clipping (vec_task.py:404-406)
            obs = self.randomizer.randomize_observations(
                k_onoise, obs, corr=getattr(state.phys, "obs_corr", None))
        obs = jnp.nan_to_num(jnp.clip(obs, -self.clip_obs, self.clip_obs))
        if states is not None:
            states = jnp.nan_to_num(
                jnp.clip(states, -self.clip_obs, self.clip_obs))
        rew = jnp.nan_to_num(rew)
        reset = jnp.where(unhealthy, 1, reset)

        new_state = EnvState(sim=sim, progress=progress, reset_buf=reset,
                             rng=key, task=task, phys=state.phys)
        return new_state, StepResult(obs=obs, states=states, rew=rew,
                                     reset=self._to_batch(reset), extras=extras)

    def reset_done(self, state: EnvState):
        """Learner-driven reset (vec_task.py:442-457, the AMP-family contract
        via learning/common_agent.py:458-460): reset every env whose
        ``reset_buf`` is set, recompute observations from the fresh sim state,
        and clear the reset flags.  Returns ``(state', obs, states)`` — the
        done-id extraction (``reset_buf.nonzero()``) happens host-side in the
        :class:`~..utils.rlgames_utils.RLGPUEnv` shim so this stays jittable.
        """
        key, k_reset, k_phys = jax.random.split(state.rng, 3)
        mask = state.reset_buf > 0
        phys = self.update_phys(state, mask, k_phys)
        sim, task = self.reset_idx(state.sim, state.task, mask, k_reset)
        sim = self._restore_lam(sim, state.sim.lam, mask)
        progress = jnp.where(mask, 0, state.progress)
        out = self.engine.forward(sim)
        mid = EnvState(sim=sim, progress=progress,
                       reset_buf=jnp.zeros_like(state.reset_buf),
                       rng=key, task=task, phys=phys)
        # obs recompute reuses the task's post_physics kernel with zero
        # actions (the reference's reset_idx -> compute_observations path);
        # reward/reset outputs are discarded, task-state updates kept.
        # pre_physics runs first (control discarded) because stash-passing
        # tasks populate per-trace state there that post_physics consumes.
        _ = self.pre_physics(mid, self.zero_actions())
        obs, states, _rew, _reset, task, _extras = self.post_physics(
            mid, out, self.zero_actions())
        obs = jnp.nan_to_num(jnp.clip(obs, -self.clip_obs, self.clip_obs))
        if states is not None:
            states = jnp.nan_to_num(
                jnp.clip(states, -self.clip_obs, self.clip_obs))
        return mid._replace(task=task), obs, states

    def _restore_lam(self, sim: SimState, lam_prev, zero_mask: jax.Array):
        """Re-attach warm-start impulses after a task's ``reset_idx`` rebuilt
        ``SimState(q, qd)`` (dropping ``lam``), zeroing them for envs that
        reset — a fresh env has no persistent contacts.  Keeps the carried
        pytree structure stable under scan."""
        if lam_prev is None:
            return sim
        if sim.lam is not None:
            lam_prev = sim.lam
        lam = tuple(
            jnp.where(zero_mask.reshape((-1,) + (1,) * (x.ndim - 1)), 0.0, x)
            for x in lam_prev)
        return sim._replace(lam=lam)

    def _to_batch(self, per_env: jax.Array) -> jax.Array:
        """Expand per-env values to per-actor rows for MA tasks.

        The MA fork folds agents into the batch axis (buffers become
        ``(num_envs * num_agents, ...)`` — franka_reach_MA.py:22-38).  Tasks
        that already emit per-actor rows pass through unchanged.
        """
        if self.num_agents == 1 or per_env.shape[0] == self.rl_games_batch:
            return per_env
        return jnp.repeat(per_env, self.num_agents, axis=0)

    def zero_actions(self) -> jax.Array:
        return jnp.zeros((self.rl_games_batch, self.num_actions), jnp.float32)

    # learner contract (SURVEY.md Appendix B / rlgames_utils.py:242-297)
    def get_env_info(self) -> dict:
        info = {
            "action_space": (self.num_actions,),
            "observation_space": (self.num_obs,),
            "agents": self.num_agents,
        }
        if self.num_states > 0:
            info["state_space"] = (self.num_states,)
        if self.dict_obs_cls and getattr(self, "obs_spec", None):
            # ComplexObsRLGPUEnv dict space (rlgames_utils.py:300-424)
            info["observation_space"] = {n: (s,) for n, s in self.obs_spec}
        return info

    def get_env_state(self, state: EnvState):
        """Curriculum/ADR state persisted into learner checkpoints
        (vec_task.py:197-205, rlgames_utils.py:285-297)."""
        return None

    def set_env_state(self, state: EnvState, env_state):
        return state

    def set_train_info(self, state: EnvState, env_frames: int):
        """Algo->env channel for curricula (vec_task.py:188-194)."""
        return state

    def render(self, state: EnvState, mode: str = "rgb_array",
               env_index: int = 0, **camera_kwargs):
        """Headless frame render (vec_task.py:459-514 ``render`` with
        ``virtual_screen_capture``): (H, W, 3) uint8 via utils/viewer.py."""
        if mode != "rgb_array":
            raise ValueError("only rgb_array rendering is supported headless")
        import numpy as _np
        from ..utils.viewer import render_rgb
        out = self.engine.forward(state.sim)
        return render_rgb(self.model,
                          _np.asarray(out.body_pos[env_index]),
                          _np.asarray(out.body_quat[env_index]),
                          ground=self.engine.ground, **camera_kwargs)


def masked_update(mask: jax.Array, new: jax.Array, old: jax.Array) -> jax.Array:
    """Apply ``new`` where mask (broadcast over trailing dims)."""
    m = mask.reshape(mask.shape + (1,) * (old.ndim - mask.ndim))
    return jnp.where(m, new, old)
