"""Device-mesh sharding for multi-GPU training (the DDP replacement).

The reference scales with one process per GPU via torchrun + rl_games DDP
(README:165-172, ``rlgames_utils.py:89-107``): each rank owns its own sim and
NCCL all-reduces gradients.  This design instead shards the SINGLE
jitted program over a ``Mesh`` with one ``env`` data axis: env state, rollout
buffers and episode trackers are sharded over envs; learner parameters,
optimizer state, and normalizer stats are replicated; XLA inserts the gradient
psum and the obs-stat reductions (NCCL on GPUs) automatically.  Multi-host just
means ``jax.distributed.initialize()`` + the same mesh over all chips
(SURVEY.md §2.6/§5-comm).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def initialize_distributed():
    """Multi-host bring-up (`jax.distributed` — call once per host)."""
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError):
        pass  # single-host / already initialized


def shard_batch_pytree(tree, mesh: Mesh, batch_sizes):
    """Shard leaves whose leading dim is one of ``batch_sizes`` over the env
    axis; replicate everything else (params, optimizer, normalizers).

    Single-process: plain ``jax.device_put``.  Multi-process (every process
    holds the same full host value, e.g. a seeded deterministic init): global
    arrays are assembled from per-process shards with
    ``jax.make_array_from_callback`` — each process contributes only its
    addressable slice.  This is the one production layout path; train.py and
    scripts/multihost_smoke.py both go through it.
    """
    env_sharding = NamedSharding(mesh, P(ENV_AXIS))
    rep_sharding = NamedSharding(mesh, P())
    sizes = set(int(b) for b in batch_sizes)
    multiprocess = jax.process_count() > 1

    def put(x):
        arr = np.asarray(x) if multiprocess else jax.numpy.asarray(x)
        sharded = (arr.ndim >= 1 and int(arr.shape[0]) in sizes
                   and arr.shape[0] % mesh.size == 0)
        sh = env_sharding if sharded else rep_sharding
        if multiprocess:
            return jax.make_array_from_callback(arr.shape, sh,
                                                lambda idx, a=arr: a[idx])
        return jax.device_put(arr, sh)

    return jax.tree.map(put, tree)


def shard_ppo_state(state, mesh: Mesh, num_envs: int, batch: int):
    """Lay out a PPOState for data-parallel training over the mesh."""
    return shard_batch_pytree(
        state, mesh, batch_sizes=(num_envs, batch, num_envs // max(1, batch // num_envs or 1)))
