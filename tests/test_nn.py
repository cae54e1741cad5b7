"""The pure-JAX layer set (learning/nn.py) and the networks built on it."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from isaacgymenvs_ma_tpu.learning import nn
from isaacgymenvs_ma_tpu.learning.networks import (
    ActorCritic, ActorCriticLSTM, AsymActorCritic, build_network)
from isaacgymenvs_ma_tpu.learning.configs import train_default_config


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


def test_actor_critic_param_tree():
    net = build_network(train_default_config("Ant")["params"]["network"], 8)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 60)))
    assert _shapes(params) == {"params": {
        "actor_mlp": {"Dense_0": {"kernel": (60, 256), "bias": (256,)},
                      "Dense_1": {"kernel": (256, 128), "bias": (128,)},
                      "Dense_2": {"kernel": (128, 64), "bias": (64,)}},
        "mu": {"kernel": (64, 8), "bias": (8,)},
        "value": {"kernel": (64, 1), "bias": (1,)},
        "log_sigma": (8,)}}
    mu, log_sigma, value = net.apply(params, jnp.ones((5, 60)))
    assert mu.shape == log_sigma.shape == (5, 8) and value.shape == (5,)


def test_init_statistics():
    """LeCun-normal kernels, zero biases, the 1%-variance fan-in truncated
    normal mu head and a constant log_sigma."""
    fan_in = 512
    net = ActorCritic(num_actions=256, units=(fan_in,), sigma_init=-0.7)
    p = net.init(jax.random.PRNGKey(1), jnp.zeros((1, fan_in)))["params"]
    k = np.asarray(p["actor_mlp"]["Dense_0"]["kernel"])
    assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.02
    assert abs(k.mean()) < 0.002
    mu_k = np.asarray(p["mu"]["kernel"])
    assert abs(mu_k.std() * np.sqrt(fan_in) - 0.1) < 0.005
    # truncated at two standard deviations of the untruncated normal
    assert np.abs(mu_k).max() <= 2.0 * 0.1 / np.sqrt(fan_in) / 0.87962566
    for layer in ("actor_mlp", "mu", "value"):
        for leaf in jax.tree.leaves(p[layer]):
            if leaf.ndim == 1:
                assert not np.any(np.asarray(leaf))
    np.testing.assert_array_equal(np.asarray(p["log_sigma"]),
                                  np.full(256, -0.7, np.float32))


def test_lstm_step_matches_numpy():
    net = ActorCriticLSTM(num_actions=3, units=(16,), lstm_units=8)
    obs = jax.random.normal(jax.random.PRNGKey(2), (4, 5))
    carry = tuple(jax.random.normal(k, (4, 8)) for k in
                  jax.random.split(jax.random.PRNGKey(3)))
    params = net.init(jax.random.PRNGKey(4), obs, carry)
    mu, _, value, (h, c) = net.apply(params, obs, carry)
    p = jax.tree.map(lambda x: np.asarray(x, np.float64), params["params"])
    x = np.asarray(obs, np.float64) @ p["actor_mlp"]["Dense_0"]["kernel"] \
        + p["actor_mlp"]["Dense_0"]["bias"]
    x = np.where(x > 0, x, np.expm1(x))                    # elu
    h0, c0 = (np.asarray(v, np.float64) for v in carry)
    lp = p["lstm"]
    gate = {g: x @ lp[f"i{g}"]["kernel"] + h0 @ lp[f"h{g}"]["kernel"]
            + lp[f"h{g}"]["bias"] for g in "ifgo"}
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    c_ref = sig(gate["f"]) * c0 + sig(gate["i"]) * np.tanh(gate["g"])
    h_ref = sig(gate["o"]) * np.tanh(c_ref)
    np.testing.assert_allclose(np.asarray(c), c_ref, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h), h_ref, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(mu), h_ref @ p["mu"]["kernel"] + p["mu"]["bias"], atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(value), (h_ref @ p["value"]["kernel"]
                            + p["value"]["bias"])[:, 0], atol=1e-5)


def test_asym_actor_critic_heads():
    net = AsymActorCritic(num_actions=4, units=(32,), cv_units=(16,))
    params = net.init(jax.random.PRNGKey(5), jnp.zeros((1, 7)),
                      jnp.zeros((1, 11)))
    assert set(params["params"]) == {"actor_mlp", "mu", "log_sigma",
                                     "critic_mlp", "value"}
    mu, ls, v = net.apply(params, jnp.ones((3, 7)), jnp.ones((3, 11)))
    assert mu.shape == ls.shape == (3, 4) and v.shape == (3,)


def test_init_is_deterministic_per_key():
    net = ActorCritic(num_actions=2, units=(8, 8))
    a = net.init(jax.random.PRNGKey(6), jnp.zeros((1, 3)))
    b = net.init(jax.random.PRNGKey(6), jnp.zeros((1, 3)))
    c = net.init(jax.random.PRNGKey(7), jnp.zeros((1, 3)))
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert not np.array_equal(a["params"]["mu"]["kernel"],
                              c["params"]["mu"]["kernel"])
    # distinct layers draw distinct values
    k0 = np.asarray(a["params"]["actor_mlp"]["Dense_0"]["kernel"])
    k1 = np.asarray(a["params"]["actor_mlp"]["Dense_1"]["kernel"])
    assert not np.allclose(k0[:3], k1[:3])


def test_matches_flax_on_the_same_params():
    """Same parameter tree and the same outputs as the flax.linen networks
    this module replaced (checked where flax happens to be installed)."""
    fnn = pytest.importorskip("flax.linen")

    class FlaxMLP(fnn.Module):
        units: tuple

        @fnn.compact
        def __call__(self, x):
            for u in self.units:
                x = fnn.elu(fnn.Dense(u)(x))
            return x

    class FlaxLSTMNet(fnn.Module):
        @fnn.compact
        def __call__(self, obs, carry):
            x = FlaxMLP((16,), name="actor_mlp")(obs)
            (c, h), y = fnn.OptimizedLSTMCell(8, name="lstm")(
                (carry[1], carry[0]), x)
            mu = fnn.Dense(3, name="mu")(y)
            value = fnn.Dense(1, name="value")(y).squeeze(-1)
            ls = self.param("log_sigma", fnn.initializers.constant(0.0), (3,))
            return mu, jnp.broadcast_to(ls, mu.shape), value, (h, c)

    obs = jax.random.normal(jax.random.PRNGKey(8), (4, 5))
    carry = (jnp.ones((4, 8)) * 0.1, jnp.ones((4, 8)) * -0.2)
    fparams = FlaxLSTMNet().init(jax.random.PRNGKey(9), obs, carry)
    ours = ActorCriticLSTM(num_actions=3, units=(16,), lstm_units=8)
    assert _shapes(ours.init(jax.random.PRNGKey(9), obs, carry)) \
        == _shapes(jax.tree.map(jnp.asarray, fparams))
    out_f = FlaxLSTMNet().apply(fparams, obs, carry)
    out_o = ours.apply(jax.tree.map(jnp.asarray, fparams), obs, carry)
    for a, b in zip(jax.tree.leaves(out_f), jax.tree.leaves(out_o)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("name", ["elu", "relu", "tanh", "selu", "swish",
                                  "sigmoid", "None"])
def test_mlp_activations(name):
    scope = nn.Scope({}, jax.random.PRNGKey(10))
    x = jnp.linspace(-2.0, 2.0, 12).reshape(3, 4)
    y = nn.mlp(scope, x, (6,), name)
    p = scope.params["Dense_0"]
    np.testing.assert_allclose(
        np.asarray(y),
        np.asarray(nn.ACTIVATIONS[name](x @ p["kernel"] + p["bias"])),
        atol=1e-6)
