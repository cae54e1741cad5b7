"""The fused FK + motion-subspace GPU kernel (physics/fk_kernel.py), run in
interpret mode against the XLA reference; the wrapper's padding, sharding
and choice of kernel."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isaacgymenvs_ma_tpu.physics import fk_kernel as fk
from isaacgymenvs_ma_tpu.parallel.mesh import make_mesh
from isaacgymenvs_ma_tpu.tasks import registry
from isaacgymenvs_ma_tpu.utils.config import deep_merge


def _task_q(name, n, seed=0):
    cfg = deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": n}})
    task = registry.create_task(name, cfg)
    q = task.initial_state(jax.random.PRNGKey(seed)).sim.q
    q = q + 0.2 * jax.random.normal(jax.random.PRNGKey(seed + 1), q.shape)
    return task.engine, q


def _assert_close(out, ref):
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-6)


# every joint type: FREE (Ant), FIXED (ShadowHand), SLIDE + SCREW (the
# screw task's nut), the fork's multi-arm scene, implicit-drive legs
@pytest.mark.parametrize("name", ["Ant", "ShadowHand",
                                  "FactoryTaskNutBoltScrew", "BallBalance",
                                  "FrankaReachMA"])
def test_fk_kernel_matches_xla(name):
    eng, q = _task_q(name, 128)
    _assert_close(fk.fk_motion_pallas(eng, q, interpret=True),
                  fk.fk_motion_xla(eng, q))


def test_fk_kernel_pads_a_ragged_batch():
    eng, q = _task_q("Ant", 130)
    out = fk.fk_motion_pallas(eng, q, interpret=True)
    assert [o.shape for o in out] == [(130, eng.nb, 3), (130, eng.nb, 4),
                                      (130, eng.nv, 6)]
    _assert_close(out, fk.fk_motion_xla(eng, q))


def test_fk_kernel_runs_per_shard_under_an_env_mesh():
    eng, q = _task_q("Ant", 8 * fk.BLOCK)
    mesh = make_mesh(8)
    q = jax.device_put(q, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("env")))
    with jax.sharding.set_mesh(mesh):
        out = jax.jit(lambda q: fk.fk_motion_kernel(eng, q,
                                                    interpret=True))(q)
    assert len(out[0].sharding.device_set) == 8
    _assert_close(out, fk.fk_motion_xla(eng, q))


def test_kernel_is_chosen_only_when_lowering_for_cuda():
    eng, q = _task_q("Ant", 128)
    f = jax.jit(lambda q: fk.fk_motion(eng, q))
    cuda = f.trace(q).lower(lowering_platforms=("cuda",)).as_text()
    cpu = f.lower(q).as_text()
    assert "__gpu$xla.gpu.triton" in cuda and "fk_motion" in cuda
    assert "triton" not in cpu
    _assert_close(f(q), fk.fk_motion_xla(eng, q))
