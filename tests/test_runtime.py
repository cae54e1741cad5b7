"""Runtime plumbing: checkpoints, optional dependencies, config parsing, the
compile cache, PBT worker placement and chip_smoke's device gate."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isaacgymenvs_ma_tpu.learning import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed):
    k = jax.random.PRNGKey(seed)
    return {"params": {"w": jax.random.normal(k, (3, 4)),
                       "log_sigma": jnp.full((4,), -0.5)},
            "step": jnp.asarray(seed, jnp.int32),
            "key": jax.random.split(k)[0],
            "mask": jnp.asarray([True, False])}


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    path = str(tmp_path / "nn" / "run.ckpt")
    src = _state(1)
    ckpt.save_checkpoint(path, src, env_state_extra={"lvl": [1, 2]},
                         meta={"epoch": 7})
    out, extra, meta = ckpt.load_checkpoint(path, _state(2))
    for a, b in zip(jax.tree.leaves(src), jax.tree.leaves(out)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert extra == {"lvl": [1, 2]} and meta == {"epoch": 7}


def test_checkpoint_rejects_another_structure(tmp_path):
    path = str(tmp_path / "run.ckpt")
    ckpt.save_checkpoint(path, _state(1))
    other = _state(1)
    other["params"]["extra"] = jnp.zeros(2)
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load_checkpoint(path, other)


@pytest.mark.parametrize("text, value", [
    ("True", True), ("false", False), ("null", None), ("~", None),
    ("4096", 4096), ("-3", -3), ("0.5", 0.5), ("1e-3", 1e-3),
    ("'quoted'", "quoted"), ("runs/Ant/nn/Ant.ckpt", "runs/Ant/nn/Ant.ckpt"),
    ("[1, 2.5, a]", [1, 2.5, "a"]), ("{a: 1, b: [x, y]}",
                                     {"a": 1, "b": ["x", "y"]}),
    ("AntPPO", "AntPPO"), ("", "")])
def test_override_values_parse_without_yaml(text, value):
    from isaacgymenvs_ma_tpu.utils.config import _parse_value
    assert _parse_value(text) == value


def test_overrides_nest():
    from isaacgymenvs_ma_tpu.utils.config import apply_overrides
    cfg = apply_overrides({"a": {"b": 1}}, ["a.c=2", "+d.e=[1, 2]"])
    assert cfg == {"a": {"b": 1, "c": 2}, "d": {"e": [1, 2]}}


def test_tensorboard_observer_is_optional(monkeypatch, tmp_path, capsys):
    from isaacgymenvs_ma_tpu.utils.observers import TensorboardObserver
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    obs = TensorboardObserver(str(tmp_path / "tb"))
    obs.after_print_stats(1, {"frames": 10, "loss": 0.5})
    assert "tensorboardX not installed" in capsys.readouterr().out


BLOCKED = textwrap.dedent("""
    import sys
    for name in ("flax", "yaml", "tensorboardX"):
        sys.modules[name] = None          # any import of them now fails
    import isaacgymenvs_ma_tpu
    from isaacgymenvs_ma_tpu.learning import amp, checkpoint, hrl, ppo, sac
    from isaacgymenvs_ma_tpu.utils import rna_util
    from isaacgymenvs_ma_tpu.train import launch
    state = launch(["task=Ant", "num_envs=16", "max_iterations=1",
                    "train.params.config.horizon_length=8",
                    "train.params.config.minibatch_size=64"])
    print("TRAINED", int(state.frames))
""")


def test_import_and_train_without_optional_packages(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TRAINED" in out.stdout
    assert "tensorboardX not installed" in out.stdout
    assert list((tmp_path / "runs").glob("*/config.json"))
    assert list((tmp_path / "runs").glob("*/nn/*.ckpt"))


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    from isaacgymenvs_ma_tpu.utils import compile_cache as cc
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.cache_dir() == os.path.join(REPO, ".jax_cache")
    old = jax.config.jax_compilation_cache_dir
    try:
        assert cc.setup_compile_cache() == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == cc.cache_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    from isaacgymenvs_ma_tpu.utils import compile_cache as cc
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert cc.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == old


def _echo_run(tmp_path, n):
    """Workers that sleep, then print the card they were given."""
    from isaacgymenvs_ma_tpu.pbt.launcher import Experiment, RunDescription
    script = tmp_path / "worker.py"
    script.write_text("import os, time\ntime.sleep(0.3)\n"
                      "print(os.environ.get('CUDA_VISIBLE_DEVICES'))\n")
    return RunDescription("cards", [
        Experiment(f"w{i}", f"{sys.executable} {script}") for i in range(n)])


def _worker_cards(train_dir):
    return sorted(open(os.path.join(train_dir, f)).read().strip()
                  for f in os.listdir(train_dir) if f.endswith(".log"))


def test_pbt_workers_get_one_card_each(tmp_path, capsys):
    from isaacgymenvs_ma_tpu.pbt.launcher import run_processes
    logs = tmp_path / "logs"
    failed = run_processes(_echo_run(tmp_path, 4), str(logs), max_parallel=8,
                           pause_between=0.0, cards=["0", "1"])
    assert failed == 0
    assert "max_parallel=2" in capsys.readouterr().out
    assert _worker_cards(str(logs)) == ["0", "0", "1", "1"]


def test_pbt_workers_share_a_cardless_host(tmp_path, monkeypatch):
    from isaacgymenvs_ma_tpu.pbt.launcher import run_processes
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    logs = tmp_path / "logs"
    assert run_processes(_echo_run(tmp_path, 2), str(logs), max_parallel=2,
                         pause_between=0.0, cards=[]) == 0
    assert _worker_cards(str(logs)) == ["None", "None"]


def test_visible_cards_follow_the_environment(monkeypatch):
    from isaacgymenvs_ma_tpu.pbt.launcher import visible_cards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2, 3")
    assert visible_cards() == ["2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert visible_cards() == []


def test_chip_smoke_refuses_a_cpu_backend():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.device_phase()


def test_chip_smoke_alone_fails(tmp_path):
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    out = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
