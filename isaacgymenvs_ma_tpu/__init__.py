"""isaacgymenvs_ma_tpu — JAX rebuild of IsaacGymEnvs-MA.

A from-scratch JAX/XLA framework with the capabilities of
Xhadow0823/IsaacGymEnvs-MA: batched rigid-body physics, the IsaacGymEnvs task
suite (incl. the fork's multi-agent Franka tasks), an rl_games-equivalent PPO
learner, domain randomization, and pod-scale sharding — all under one jit.

Public API mirrors the reference's ``isaacgymenvs.make()``
(reference isaacgymenvs/__init__.py:14-55).
"""
__version__ = "0.1.0"

from .api import make  # noqa: F401
