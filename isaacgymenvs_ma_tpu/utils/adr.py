"""Automatic Domain Randomization (reference tasks/dextreme/adr_vec_task.py
:368-920 — worker modes, boundary performance queues, range updates).

Batched redesign: instead of host-side queues and per-env worker-mode
bookkeeping, ADR state is a small pytree updated with masked reductions
inside the jitted step:

* each randomized parameter p has an adaptive range ``[lo_p, hi_p]`` inside
  hard outer limits,
* a static fraction of envs are **boundary workers**: env e probes parameter
  ``param(e)`` pinned at side ``side(e)`` (round-robin assignment),
* when a boundary env finishes an episode, its performance lands in that
  (param, side) accumulator; once ``queue_size`` episodes accumulate, the
  boundary moves: performance >= ``threshold_high`` -> expand by ``delta``,
  <= ``threshold_low`` -> contract; then the accumulator resets,
* regular envs sample uniformly inside the current ranges.

The resulting ranges are the ``get_env_state``/checkpoint payload
(``adr_load_from_checkpoint`` — docs/domain_randomization.md:337).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class ADRConfig(NamedTuple):
    names: tuple                  # parameter names (P,)
    init_lo: tuple                # initial range low
    init_hi: tuple
    limit_lo: tuple               # hard outer limits
    limit_hi: tuple
    delta: tuple                  # boundary step per update
    queue_size: int = 256
    threshold_low: float = 0.05   # contract below
    threshold_high: float = 0.2   # expand above
    worker_fraction: float = 0.25


class ADRState(NamedTuple):
    ranges: jax.Array       # (P, 2) current [lo, hi]
    perf_sum: jax.Array     # (P, 2) accumulated boundary performance
    perf_cnt: jax.Array     # (P, 2)
    num_updates: jax.Array  # (P, 2) expansion/contraction counter


class ADR:
    def __init__(self, cfg: ADRConfig, num_envs: int):
        self.cfg = cfg
        self.num_envs = num_envs
        P = len(cfg.names)
        self.P = P
        n_workers = int(num_envs * cfg.worker_fraction)
        # static round-robin assignment: env -> (param, side); -1 = regular
        assign_p = np.full(num_envs, -1, np.int32)
        assign_s = np.zeros(num_envs, np.int32)
        slots = P * 2
        for i in range(n_workers):
            assign_p[i] = (i % slots) // 2
            assign_s[i] = i % 2
        self.assign_p = jnp.asarray(assign_p)
        self.assign_s = jnp.asarray(assign_s)
        self.is_worker = jnp.asarray(assign_p >= 0)

    def init(self) -> ADRState:
        c = self.cfg
        return ADRState(
            ranges=jnp.asarray(np.stack([c.init_lo, c.init_hi], -1), jnp.float32),
            perf_sum=jnp.zeros((self.P, 2), jnp.float32),
            perf_cnt=jnp.zeros((self.P, 2), jnp.float32),
            num_updates=jnp.zeros((self.P, 2), jnp.float32),
        )

    # ------------------------------------------------------------------
    def sample(self, key: jax.Array, state: ADRState) -> jax.Array:
        """Per-env parameter values (N, P): regular envs uniform in range,
        boundary workers pinned to their boundary value."""
        lo = state.ranges[:, 0]
        hi = state.ranges[:, 1]
        u = jax.random.uniform(key, (self.num_envs, self.P))
        vals = lo + u * (hi - lo)
        # pin workers: env e, param assign_p[e] <- ranges[p, side]
        bound_val = state.ranges[jnp.maximum(self.assign_p, 0), self.assign_s]
        onehot = jax.nn.one_hot(jnp.maximum(self.assign_p, 0), self.P)
        pin = self.is_worker[:, None] * onehot
        return vals * (1 - pin) + pin * bound_val[:, None]

    def observe(self, state: ADRState, done_mask: jax.Array,
                performance: jax.Array) -> ADRState:
        """Accumulate boundary performances for envs finishing episodes and
        apply boundary updates where queues are full."""
        c = self.cfg
        contrib = (done_mask & self.is_worker).astype(jnp.float32)
        seg = jax.nn.one_hot(jnp.maximum(self.assign_p, 0), self.P)[:, :, None] \
            * jax.nn.one_hot(self.assign_s, 2)[:, None, :] \
            * contrib[:, None, None]
        perf_sum = state.perf_sum + jnp.einsum("nps,n->ps", seg, performance)
        perf_cnt = state.perf_cnt + jnp.sum(seg, axis=0)

        full = perf_cnt >= c.queue_size
        mean_perf = perf_sum / jnp.maximum(perf_cnt, 1.0)
        expand = full & (mean_perf >= c.threshold_high)
        contract = full & (mean_perf <= c.threshold_low)
        delta = jnp.asarray(c.delta, jnp.float32)
        limit_lo = jnp.asarray(c.limit_lo, jnp.float32)
        limit_hi = jnp.asarray(c.limit_hi, jnp.float32)
        lo, hi = state.ranges[:, 0], state.ranges[:, 1]
        # side 0 = low boundary (expanding means decreasing lo)
        lo = jnp.where(expand[:, 0], jnp.maximum(lo - delta, limit_lo), lo)
        lo = jnp.where(contract[:, 0], jnp.minimum(lo + delta, hi), lo)
        hi = jnp.where(expand[:, 1], jnp.minimum(hi + delta, limit_hi), hi)
        hi = jnp.where(contract[:, 1], jnp.maximum(hi - delta, lo), hi)
        ranges = jnp.stack([lo, hi], -1)
        # reset consumed queues
        perf_sum = jnp.where(full, 0.0, perf_sum)
        perf_cnt = jnp.where(full, 0.0, perf_cnt)
        num_updates = (state.num_updates + expand.astype(jnp.float32)
                       + contract.astype(jnp.float32))
        return ADRState(ranges=ranges, perf_sum=perf_sum, perf_cnt=perf_cnt,
                        num_updates=num_updates)

    def sample_phys(self, key: jax.Array, state: ADRState):
        """ADR-driven :class:`~..utils.domain_rand.PhysScales` — the four
        engine-level factors sampled from the adaptive ranges.  Requires
        ``cfg.names == PHYS_PARAM_NAMES``."""
        from .domain_rand import PhysScales
        vals = self.sample(key, state)  # (N, 4)
        return PhysScales(mass=vals[:, 0:1], damping=vals[:, 1:2],
                          stiffness=vals[:, 2:3], friction=vals[:, 3:4])

    def npd(self, state: ADRState) -> jax.Array:
        """Mean normalized range width — the dextreme ADR progress metric."""
        c = self.cfg
        span = jnp.asarray(c.limit_hi, jnp.float32) - jnp.asarray(c.limit_lo, jnp.float32)
        width = state.ranges[:, 1] - state.ranges[:, 0]
        return jnp.mean(width / jnp.maximum(span, 1e-9))


def adr_config_from_params(adr_cfg: dict) -> ADRConfig:
    """Build an :class:`ADRConfig` from a reference-style ``adr`` config tree
    (cfg/task/AllegroHandDextremeADR.yaml:227-422):

    .. code-block:: yaml

        adr:
          worker_adr_boundary_fraction: 0.4
          adr_queue_threshold_length: 256
          adr_objective_threshold_low: 5
          adr_objective_threshold_high: 20
          params:
            hand_damping: {init_range: [0.5, 2.0], limits: [0.01, 20.0],
                           delta: 0.01}
            ...

    Parameter order follows the dict order of ``params`` — tasks look values
    up by name through the returned ``names`` tuple.
    """
    params = adr_cfg["params"]
    names, lo0, hi0, llo, lhi, dl = [], [], [], [], [], []
    for name, p in params.items():
        names.append(name)
        lo0.append(float(p["init_range"][0]))
        hi0.append(float(p["init_range"][1]))
        llo.append(float(p["limits"][0]))
        lhi.append(float(p["limits"][1]))
        dl.append(float(p.get("delta", 0.01)))
    return ADRConfig(
        names=tuple(names), init_lo=tuple(lo0), init_hi=tuple(hi0),
        limit_lo=tuple(llo), limit_hi=tuple(lhi), delta=tuple(dl),
        queue_size=int(adr_cfg.get("adr_queue_threshold_length", 256)),
        threshold_low=float(adr_cfg.get("adr_objective_threshold_low", 5.0)),
        threshold_high=float(adr_cfg.get("adr_objective_threshold_high",
                                         20.0)),
        worker_fraction=float(adr_cfg.get("worker_adr_boundary_fraction",
                                          0.4)))


PHYS_PARAM_NAMES = ("mass", "damping", "stiffness", "friction")


def phys_adr(num_envs: int, **overrides) -> ADR:
    """ADR over the engine's multiplicative PhysScales factors (the batched
    counterpart of dextreme's per-property adr ranges —
    tasks/dextreme/allegro_hand_dextreme.py custom ranges in task yaml)."""
    cfg = ADRConfig(
        names=PHYS_PARAM_NAMES,
        init_lo=(0.95, 0.95, 0.95, 0.95),
        init_hi=(1.05, 1.05, 1.05, 1.05),
        limit_lo=(0.4, 0.4, 0.4, 0.4),
        limit_hi=(2.0, 2.0, 2.0, 2.0),
        delta=(0.02, 0.02, 0.02, 0.02),
    )._replace(**overrides)
    return ADR(cfg, num_envs)
