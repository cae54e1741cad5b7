"""Domain randomization engine (reference ``vec_task.py:612-842`` +
``utils/dr_utils.py``), batched in JAX.

The reference mutates PhysX actor properties through host-side setter maps
(``dr_utils.py:35-69``), needs value "bucketing" to bound GPU buffer growth
(:135-146), and randomizes obs/actions with schedule-scaled noise.  Here the
physics core is already batched, so per-env physical parameters are just
batched leaves of a :class:`PhysScales` pytree resampled (masked, at reset)
inside the jitted step — no bucketing, no host calls.

Schema-compatible with the reference's ``randomization_params`` tree
(cfg/task/Ant.yaml:66-105): ``frequency``, ``observations``/``actions`` noise
specs ({range, operation: additive|scaling, distribution: gaussian|uniform|
loguniform, schedule: linear|constant}), and ``actor_params.<actor>.
{rigid_body_properties.mass, dof_properties.{damping,stiffness,friction}}``
as scaling/additive factors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class PhysScales(NamedTuple):
    """Per-env multiplicative physics factors consumed by the engine."""

    mass: jax.Array        # (N, 1) or (N, nb)
    damping: jax.Array     # (N, 1) or (N, nv) — passive + drive damping
    stiffness: jax.Array   # (N, 1) or (N, nv) — drive kp
    friction: jax.Array    # (N, 1) global or (N, nb) per-BODY contact
    #                        friction scale (rows combine endpoint bodies)
    # (N, nb, 3) anisotropic per-body geometry scale (object-dimension DR,
    # reference allegro_kuka/generate_cuboids.py); None = nominal shapes
    shape: Optional[jax.Array] = None
    # correlated-noise bases (standard normal), cached between randomization
    # events like the reference's params['corr'] (vec_task.py:686-692)
    obs_corr: Optional[jax.Array] = None   # (N, num_obs)
    act_corr: Optional[jax.Array] = None   # (N, num_actions)
    # dof-property DR (reference dof_properties.{friction,armature,effort,
    # lower,upper}.range — dextreme ADR tree): multiplicative scales on the
    # model's dof friction / armature / drive-force limit, and ADDITIVE
    # shifts of the joint limits; None = nominal
    joint_friction: Optional[jax.Array] = None  # (N, 1) or (N, nv) scale
    armature: Optional[jax.Array] = None        # (N, 1) or (N, nv) scale
    effort: Optional[jax.Array] = None          # (N, 1) or (N, nv) scale
    dof_lower_shift: Optional[jax.Array] = None  # (N, 1) or (N, nv) rad
    dof_upper_shift: Optional[jax.Array] = None  # (N, 1) or (N, nv) rad
    # per-body restitution VALUES in [0, 1] (rigid_shape_properties
    # .restitution — PhysX average combine across the pair); None = 0
    restitution: Optional[jax.Array] = None     # (N, 1) or (N, nb)

    @staticmethod
    def ones(n: int) -> "PhysScales":
        one = jnp.ones((n, 1), jnp.float32)
        return PhysScales(one, one, one, one)


def _schedule_factor(spec: dict, frames) -> jax.Array:
    sched = spec.get("schedule", None)
    steps = float(spec.get("schedule_steps", 1)) or 1.0
    if sched == "linear":
        return jnp.minimum(frames / steps, 1.0)
    if sched == "constant":
        return (frames >= steps).astype(jnp.float32)
    return jnp.asarray(1.0, jnp.float32)


def _sample(key, spec: dict, shape, frames):
    """Draw a noise/scale sample per the reference's generate_random_samples
    (dr_utils.py:71-133)."""
    lo, hi = spec.get("range", [0.0, 1.0])
    dist = spec.get("distribution", "uniform")
    op = spec.get("operation", "additive")
    sf = _schedule_factor(spec, frames)
    if dist == "gaussian":
        mu, var = lo, hi
        if op == "additive":
            mu, var = mu * sf, var * sf
        else:  # scaling: anneal toward identity
            var = var * sf
            mu = mu * sf + 1.0 * (1.0 - sf)
        return mu + var * jax.random.normal(key, shape)
    if dist == "loguniform":
        lo_s, hi_s = jnp.log(jnp.maximum(lo, 1e-8)), jnp.log(jnp.maximum(hi, 1e-8))
        u = jax.random.uniform(key, shape, minval=lo_s, maxval=hi_s)
        samples = jnp.exp(u)
    else:
        samples = jax.random.uniform(key, shape, minval=lo, maxval=hi)
    if op == "additive":
        return samples * sf
    return samples * sf + 1.0 * (1.0 - sf)


def _corr_term(spec: dict, base, frames):
    """Correlated-noise contribution from a cached standard-normal base
    (reference vec_task.py:686-692, 710-717: corr*var_corr + mu_corr, with
    the same schedule scaling as the white part; the reference uses a
    normal base for the uniform distribution too)."""
    lo_c, hi_c = spec.get("range_correlated", [0.0, 0.0])
    op = spec.get("operation", "additive")
    dist = spec.get("distribution", "uniform")
    sf = _schedule_factor(spec, frames)
    if dist == "gaussian":
        mu_c, var_c = lo_c, hi_c
        if op == "additive":
            mu_c, var_c = mu_c * sf, var_c * sf
        else:
            var_c = var_c * sf
            mu_c = mu_c * sf + 1.0 * (1.0 - sf)
        return base * var_c + mu_c
    if op == "additive":
        lo_c, hi_c = lo_c * sf, hi_c * sf
    else:
        lo_c = lo_c * sf + 1.0 * (1.0 - sf)
        hi_c = hi_c * sf + 1.0 * (1.0 - sf)
    return base * (hi_c - lo_c) + lo_c


def _has_corr(spec) -> bool:
    return bool(spec) and any(spec.get("range_correlated", [0.0, 0.0]))


class DomainRandomizer:
    """Holds the parsed spec; all apply/resample methods are pure."""

    def __init__(self, params: dict, num_envs: int,
                 num_obs: Optional[int] = None,
                 num_actions: Optional[int] = None):
        self.params = params or {}
        self.num_envs = num_envs
        self.frequency = int(self.params.get("frequency", 600))
        self.obs_spec = self.params.get("observations")
        self.act_spec = self.params.get("actions")
        # correlated noise needs per-env cached bases of known width
        self._num_obs = num_obs
        self._num_actions = num_actions
        self.obs_corr_on = _has_corr(self.obs_spec) and num_obs is not None
        self.act_corr_on = (_has_corr(self.act_spec)
                            and num_actions is not None)
        # flatten actor_params into per-property specs.  mass and scale keep
        # their actor attribution (applied per body range once bind_model
        # resolves actors); dof/friction factors stay scene-global (N, 1).
        self.mass_specs = []       # [(actor, spec)]
        self.damping_spec = None
        self.stiffness_spec = None
        self.friction_spec = None
        # per-actor geometry scale specs (actor_params.<actor>.scale — e.g.
        # Trifinger.yaml object scale [0.97, 1.03] setup_only); consumed as
        # PhysScales.shape leaves once bind_model resolves actors to bodies
        self.scale_specs = {}
        self._actor_bodies = {}
        self._nb = None
        for actor, props in (self.params.get("actor_params") or {}).items():
            rb = props.get("rigid_body_properties", {})
            if "mass" in rb:
                self.mass_specs.append((actor, rb["mass"]))
            dp = props.get("dof_properties", {})
            if "damping" in dp:
                self.damping_spec = dp["damping"]
            if "stiffness" in dp:
                self.stiffness_spec = dp["stiffness"]
            rs = props.get("rigid_shape_properties", {})
            if "friction" in rs:
                self.friction_spec = rs["friction"]
            if "scale" in props:
                self.scale_specs[actor] = props["scale"]

    def bind_model(self, model):
        """Resolve actor names in mass/scale specs to body-index ranges (an
        actor's bodies are contiguous after compose_scene; matched by
        root-body name, the analog of the reference's create_actor name).
        Unresolved actors fall back to scene-global application."""
        self._nb = int(model.nb)
        names = ({a for a, _ in self.mass_specs} | set(self.scale_specs))
        if not names:
            return
        roots = np.asarray(model.actor_root_body, np.int32)
        ends = list(roots[1:]) + [model.nb]
        for actor in names:
            for r, e_ in zip(roots, ends):
                if model.body_names[int(r)] == actor:
                    self._actor_bodies[actor] = np.arange(r, e_,
                                                          dtype=np.int32)
                    break

    # -- mass ------------------------------------------------------------
    def _apply_mass_specs(self, key, mask, cur, setup_pass: bool, frames=1e9):
        """Apply mass specs whose setup_only flag matches ``setup_pass``.
        ``mask`` None = all envs (initial sampling).  Per-actor when bound,
        scene-global otherwise."""
        specs = [(a, s) for a, s in self.mass_specs
                 if bool(s.get("setup_only", False)) == setup_pass]
        if not specs:
            return cur
        n = self.num_envs
        for actor, spec in specs:
            key, k = jax.random.split(key)
            s = _sample(k, spec, (n, 1), frames)
            if spec.get("operation") == "additive":
                s = 1.0 + s
            bodies = self._actor_bodies.get(actor)
            if bodies is None:
                new = jnp.broadcast_to(s, cur.shape)
                cur = new if mask is None else jnp.where(mask[:, None],
                                                         new, cur)
            else:
                if cur.shape[-1] != self._nb:
                    cur = jnp.broadcast_to(cur, (n, self._nb))
                new = jnp.broadcast_to(s, (n, len(bodies)))
                old = cur[:, bodies]
                cur = cur.at[:, bodies].set(
                    new if mask is None else jnp.where(mask[:, None],
                                                       new, old))
        return cur

    def initial_phys(self, key, nb: int) -> PhysScales:
        """:class:`PhysScales` at t=0: setup_only specs (sampled once before
        simulation — reference domain_randomization.md 'Property will only be
        randomized once') drawn here; everything else nominal."""
        phys = PhysScales.ones(self.num_envs)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        phys = phys._replace(
            mass=self._apply_mass_specs(k1, None, phys.mass, True))
        shape = self.initial_shape(k2, nb)
        if shape is not None:
            phys = phys._replace(shape=shape)
        if self.obs_corr_on:
            phys = phys._replace(obs_corr=jax.random.normal(
                k3, (self.num_envs, self._num_obs)))
        if self.act_corr_on:
            phys = phys._replace(act_corr=jax.random.normal(
                k4, (self.num_envs, self._num_actions)))
        return phys

    def _sample_scale(self, key, spec):
        s = _sample(key, spec, (self.num_envs, 1, 1), 1e9)
        if spec.get("operation") == "additive":
            s = 1.0 + s
        return s

    def _scale_bound(self):
        return {a: b for a, b in self._actor_bodies.items()
                if a in self.scale_specs}

    def initial_shape(self, key, nb: int) -> Optional[jax.Array]:
        """(N, nb, 3) per-body geometry scales, or None when no scale specs
        bind.  Covers setup_only specs (sampled once, before simulation)."""
        bound = self._scale_bound()
        if not bound:
            return None
        shape = jnp.ones((self.num_envs, nb, 3), jnp.float32)
        for actor, bodies in bound.items():
            key, k = jax.random.split(key)
            s = self._sample_scale(k, self.scale_specs[actor])
            shape = shape.at[:, bodies, :].set(
                jnp.broadcast_to(s, (self.num_envs, len(bodies), 3)))
        return shape

    def resample_shape(self, key, mask, shape):
        """Masked at-reset resample of non-setup_only scale specs."""
        bound = self._scale_bound()
        if shape is None or not bound:
            return shape
        for actor, bodies in bound.items():
            spec = self.scale_specs[actor]
            if spec.get("setup_only", False):
                continue
            key, k = jax.random.split(key)
            new = jnp.broadcast_to(self._sample_scale(k, spec),
                                   (self.num_envs, len(bodies), 3))
            shape = shape.at[:, bodies, :].set(
                jnp.where(mask[:, None, None], new, shape[:, bodies, :]))
        return shape

    @property
    def enabled(self) -> bool:
        return bool(self.params)

    # -- noise -----------------------------------------------------------
    def randomize_actions(self, key, actions, frames=1e9, corr=None):
        if not self.act_spec:
            return actions
        noise = _sample(key, self.act_spec, actions.shape, frames)
        if corr is not None:
            noise = noise + _corr_term(self.act_spec, corr, frames)
        if self.act_spec.get("operation", "additive") == "additive":
            return actions + noise
        return actions * noise

    def randomize_observations(self, key, obs, frames=1e9, corr=None):
        if not self.obs_spec:
            return obs
        noise = _sample(key, self.obs_spec, obs.shape, frames)
        if corr is not None:
            noise = noise + _corr_term(self.obs_spec, corr, frames)
        if self.obs_spec.get("operation", "additive") == "additive":
            return obs + noise
        return obs * noise

    # -- physics ---------------------------------------------------------
    def resample_phys(self, key, mask, phys: PhysScales, frames=1e9) -> PhysScales:
        """Masked per-env resample (DR happens at reset — tasks/ant.py:252-255)."""
        n = self.num_envs
        ks = jax.random.split(key, 7)
        m = mask[:, None]

        def upd(spec, k, cur):
            if not spec:
                return cur
            new = _sample(k, spec, (n, 1), frames)
            if spec.get("operation") == "additive":
                new = 1.0 + new  # additive on a multiplicative factor
            return jnp.where(m, new, cur)

        return PhysScales(
            mass=self._apply_mass_specs(ks[0], mask, phys.mass, False,
                                        frames),
            damping=upd(self.damping_spec, ks[1], phys.damping),
            stiffness=upd(self.stiffness_spec, ks[2], phys.stiffness),
            friction=upd(self.friction_spec, ks[3], phys.friction),
            # setup_only scale specs (and task-owned object-dimension DR)
            # stay fixed; non-setup_only scale specs resample at reset
            shape=self.resample_shape(ks[4], mask, phys.shape),
            # correlated-noise bases refresh at randomization events
            # (reference rebuilds noise_lambda params, dropping the cache)
            obs_corr=None if phys.obs_corr is None else jnp.where(
                m, jax.random.normal(ks[5], phys.obs_corr.shape),
                phys.obs_corr),
            act_corr=None if phys.act_corr is None else jnp.where(
                m, jax.random.normal(ks[6], phys.act_corr.shape),
                phys.act_corr),
        )
