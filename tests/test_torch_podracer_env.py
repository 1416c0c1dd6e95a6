"""The port's functional env forms (`ray_tpu_torch/rllib/podracer/torch_env.py`)
against the reference's (`ray_tpu/rllib/podracer/jax_env.py`), transition by
transition, and against the port's numpy VectorEnvs.

Protocol (as `tests/test_podracer_env_parity.py` holds numpy against JAX):
both sides are forced onto the same PRE-step state each step (rebuilt from
the numpy env's internals), given the same actions and the same reset
draws — JAX's `autoreset_step` draws its resets from a key, the port's
takes the unit uniforms JAX draws from that key (`jax.random.uniform(key,
shape)`), which it maps to the reference's bounds as JAX maps its own. So
the comparisons are per transition: reward, terminated, truncated, done,
ep_ret, ep_len and the next observation (the reset one where an episode
ended). A done flag may differ only at a state within float epsilon of a
termination threshold; the test reports that margin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.podracer import jax_env
from ray_tpu_torch.rllib.env.cartpole import THETA_THRESHOLD, X_THRESHOLD, VectorCartPole
from ray_tpu_torch.rllib.env.pendulum import VectorPendulum
from ray_tpu_torch.rllib.podracer import torch_env
from ray_tpu_torch.rllib.podracer.torch_env import (
    TorchCartPole,
    TorchPendulum,
    autoreset_step,
    init_env_state,
    make_torch_env,
    torch_env_registered,
)

N = 16
STEPS = 120
TOL = 1e-6      # one f32 step of the same ops: |d| <= TOL·(1 + |ref|)
EDGE = 1e-5     # a done flag may differ only this close to a threshold


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, t):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= TOL * (1 + np.abs(want))), f"{what} at step {t}: {err.max()}"


def _margin(core: np.ndarray) -> np.ndarray:
    """Each env's distance from the nearest termination threshold."""
    return np.minimum(np.abs(np.abs(core[:, 0]) - X_THRESHOLD), np.abs(np.abs(core[:, 2]) - THETA_THRESHOLD))


def _both_steps(jx, tc, est_np, actions, key, unit):
    """One wrapped step of the reference and of the port from the same
    pre-step state (numpy), actions and reset key; the port's reset
    uniforms are `unit(key)`, JAX's unit draws from that key."""
    j_est = {k: jnp.asarray(v) for k, v in est_np.items()}
    t_est = {k: torch.from_numpy(np.array(v)) for k, v in est_np.items()}
    j_new, j_out = jax_env.autoreset_step(jx, j_est, jnp.asarray(actions), key)
    u = torch.from_numpy(np.array(unit(key)))
    t_new, t_out = autoreset_step(tc, t_est, torch.from_numpy(np.array(actions)), u)
    return j_est, (j_new, j_out), (t_new, t_out)


def _compare(jx, tc, j, t, raw, step, margins):
    (j_new, j_out), (t_new, t_out) = j, t
    done_j, done_t = np.asarray(j_out["done"]) > 0, t_out["done"].numpy() > 0
    differ = done_j != done_t
    if differ.any():
        m = _margin(raw)[differ]
        margins.extend(m.tolist())
        assert np.all(m < EDGE), f"done differs at step {step} away from a threshold: margins {m}"
    same = ~differ
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(t_out[k].numpy()[same], np.asarray(j_out[k])[same], err_msg=f"{k} {step}")
    for k in ("reward", "ep_ret"):
        _close(t_out[k].numpy(), np.asarray(j_out[k]), k, step)
    np.testing.assert_array_equal(t_out["ep_len"].numpy(), np.asarray(j_out["ep_len"]))
    assert t_out["ep_len"].dtype == torch.int32 and t_out["done"].dtype == torch.float32
    # The next observation: the reset one where an episode ended.
    _close(tc.observe_fn(t_new["core"]).numpy()[same], np.asarray(jx.observe_fn(j_new["core"]))[same], "obs",
           step)
    np.testing.assert_array_equal(t_new["steps"].numpy()[same], np.asarray(j_new["steps"])[same])
    _close(t_new["ep_ret"].numpy()[same], np.asarray(j_new["ep_ret"])[same], "ep_ret after", step)


def test_cartpole_matches_the_reference_per_transition():
    np_env = VectorCartPole(N, max_episode_steps=50)
    jx, tc = jax_env.JaxCartPole(max_episode_steps=50), TorchCartPole(max_episode_steps=50)
    np_env.reset(seed=0)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    margins, resets = [], 0
    for t in range(STEPS):
        est = {"core": np_env._state.astype(np.float32), "steps": np_env._steps.astype(np.int32),
               "ep_ret": np_env._steps.astype(np.float32)}
        actions = rng.integers(0, 2, N).astype(np.int32)
        key, k = jax.random.split(key)
        j_est, j, tt = _both_steps(jx, tc, est, actions, k, lambda k: np.asarray(jax.random.uniform(k, (N, 4))))
        raw = np.asarray(jx.step_fn(j_est["core"], jnp.asarray(actions))[0])
        _compare(jx, tc, j, tt, raw, t, margins)
        resets += int(np.asarray(j[1]["done"]).sum())
        np_env.step(actions)
    assert resets > 10  # episodes end and reset inside the window
    print(f"cartpole: {resets} resets; done flags differing {len(margins)}, margins {margins}")


def test_pendulum_matches_the_reference_per_transition():
    np_env = VectorPendulum(N, max_episode_steps=40)
    jx, tc = jax_env.JaxPendulum(max_episode_steps=40), TorchPendulum(max_episode_steps=40)
    np_env.reset(seed=3)
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(5)

    def unit(k):  # the reference's two reset keys (theta, theta_dot) as the port's two columns
        k_th, k_dot = jax.random.split(k)
        return np.stack([np.asarray(jax.random.uniform(k_th, (N,))), np.asarray(jax.random.uniform(k_dot, (N,)))],
                        axis=1)

    truncations = 0
    for t in range(STEPS):
        est = {"core": np.stack([np_env._theta, np_env._theta_dot], axis=1).astype(np.float32),
               "steps": np_env._steps.astype(np.int32), "ep_ret": np_env._ep_ret.astype(np.float32)}
        actions = rng.uniform(-2.0, 2.0, (N, 1)).astype(np.float32)
        key, k = jax.random.split(key)
        _, j, tt = _both_steps(jx, tc, est, actions, k, unit)
        # Pendulum never terminates: every done is a truncation, exact.
        np.testing.assert_array_equal(tt[1]["done"].numpy(), np.asarray(j[1]["done"]))
        _compare(jx, tc, j, tt, None, t, [])
        truncations += int(np.asarray(j[1]["truncated"]).sum())
        np_env.step(actions)
    assert truncations >= N


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_reset_matches_the_references_draws(name):
    """init_env_state from JAX's unit uniforms equals the reference's reset
    from the same key (the bounds mapped as `jax.random.uniform` maps them)."""
    key = jax.random.PRNGKey(7)
    ref = jax_env.init_env_state(jax_env.make_jax_env(name), key, 64)
    if name == "CartPole-v1":
        u = np.array(jax.random.uniform(key, (64, 4)))
    else:
        k_th, k_dot = jax.random.split(key)
        u = np.stack([np.asarray(jax.random.uniform(k_th, (64,))), np.asarray(jax.random.uniform(k_dot, (64,)))], 1)
    got = init_env_state(make_torch_env(name), torch.from_numpy(u))
    for k in ("core", "steps", "ep_ret"):
        assert got[k].shape == ref[k].shape and str(got[k].dtype).endswith(str(ref[k].dtype)), k
        _close(got[k].numpy(), np.asarray(ref[k]), k, 0)


def test_cartpole_matches_the_ports_numpy_env():
    """The torch form against the port's numpy VectorCartPole, from the same
    pre-step state each step: masks, rewards, the live cores, episode
    lengths at done and fresh resets inside the bounds."""
    np_env, tc = VectorCartPole(N, max_episode_steps=50), TorchCartPole(max_episode_steps=50)
    np_env.reset(seed=0)
    rng, gen = np.random.default_rng(1), torch.Generator().manual_seed(2)
    for t in range(STEPS):
        est = {"core": torch.from_numpy(np_env._state.astype(np.float32)),
               "steps": torch.from_numpy(np_env._steps.astype(np.int32)),
               "ep_ret": torch.from_numpy(np_env._steps.astype(np.float32))}
        actions = rng.integers(0, 2, N)
        raw = tc.step_fn(est["core"], torch.from_numpy(actions))[0].numpy()
        new, out = autoreset_step(tc, est, torch.from_numpy(actions), tc.draw_reset(gen, (N,)))
        obs, rew, term, trunc, info = np_env.step(actions)
        safe = _margin(raw) > 1e-4
        np.testing.assert_array_equal(out["terminated"].numpy()[safe], term[safe])
        np.testing.assert_array_equal(out["truncated"].numpy()[safe], trunc[safe])
        np.testing.assert_array_equal(out["reward"].numpy(), rew)
        done = term | trunc
        live = safe & ~done & ~(out["done"].numpy() > 0)
        np.testing.assert_allclose(new["core"].numpy()[live], np_env._state[live], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.observe_fn(new["core"]).numpy()[live], obs[live], rtol=1e-5, atol=1e-5)
        both = done & (out["done"].numpy() > 0)
        if both.any():
            assert sorted(out["ep_len"].numpy()[both].tolist()) == sorted(
                n for i, n in zip(np.nonzero(done)[0], info["episode_lengths"]) if both[i])
            assert np.all(np.abs(new["core"].numpy()[both]) <= 0.05 + 1e-6)
            assert np.all(new["steps"].numpy()[both] == 0) and np.all(new["ep_ret"].numpy()[both] == 0)


def test_pendulum_matches_the_ports_numpy_env():
    np_env, tc = VectorPendulum(N, max_episode_steps=40), TorchPendulum(max_episode_steps=40)
    np_env.reset(seed=3)
    rng, gen = np.random.default_rng(4), torch.Generator().manual_seed(5)
    for _ in range(STEPS):
        pre_steps, pre_ret = np_env._steps.copy(), np_env._ep_ret.copy()
        est = {"core": torch.from_numpy(np.stack([np_env._theta, np_env._theta_dot], 1).astype(np.float32)),
               "steps": torch.from_numpy(pre_steps.astype(np.int32)),
               "ep_ret": torch.from_numpy(pre_ret.astype(np.float32))}
        actions = rng.uniform(-2.0, 2.0, (N, 1)).astype(np.float32)
        new, out = autoreset_step(tc, est, torch.from_numpy(actions), tc.draw_reset(gen, (N,)))
        obs, rew, term, trunc, _ = np_env.step(actions)
        assert not out["terminated"].any() and not term.any()
        np.testing.assert_array_equal(out["truncated"].numpy(), trunc)
        np.testing.assert_allclose(out["reward"].numpy(), rew, rtol=1e-4, atol=1e-4)
        live = ~trunc
        np.testing.assert_allclose(new["core"].numpy()[live, 0], np_env._theta[live], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tc.observe_fn(new["core"]).numpy()[live], obs[live], rtol=1e-4, atol=1e-4)
        if trunc.any():
            np.testing.assert_allclose(out["ep_ret"].numpy()[trunc], (pre_ret + rew)[trunc], rtol=1e-3, atol=1e-3)
            np.testing.assert_array_equal(out["ep_len"].numpy()[trunc], (pre_steps + 1)[trunc])
            assert np.all(new["steps"].numpy()[trunc] == 0)
            theta = new["core"].numpy()[trunc, 0]
            assert np.all(np.abs(theta) <= np.pi + 1e-6)


def test_autoreset_loop_accounting():
    """The wrapper over a 200-step loop (the Anakin rollout's shape): every
    completed length within [1, max_episode_steps], and completed lengths
    plus live counters equal the steps taken."""
    env, n, T = TorchCartPole(max_episode_steps=25), 8, 200
    gen = torch.Generator().manual_seed(0)
    est = init_env_state(env, env.draw_reset(gen, (n,)))
    done, lens = [], []
    for _ in range(T):
        action = (torch.rand(n, generator=gen) < 0.5).to(torch.int32)
        est, out = autoreset_step(env, est, action, env.draw_reset(gen, (n,)))
        done.append(out["done"])
        lens.append(out["ep_len"])
    done, lens = torch.stack(done).numpy(), torch.stack(lens).numpy()
    finished = lens[done > 0]
    assert finished.size > 0 and finished.min() >= 1 and finished.max() <= 25
    assert finished.sum() + est["steps"].numpy().sum() == T * n


def test_registry_surface():
    assert torch_env_registered("CartPole-v1") and torch_env_registered("Pendulum-v1")
    assert not torch_env_registered("MultiCartPole")
    assert isinstance(make_torch_env("CartPole-v1"), TorchCartPole)
    assert isinstance(make_torch_env("Pendulum-v1", max_episode_steps=7), TorchPendulum)
    assert make_torch_env("Pendulum-v1", max_episode_steps=7).max_episode_steps == 7
    with pytest.raises(KeyError, match="[Ss]ebulba"):
        make_torch_env("NotAnEnv-v0")
    # The spaces size the policy as the numpy env's do.
    for name, np_env in (("CartPole-v1", VectorCartPole(1)), ("Pendulum-v1", VectorPendulum(1))):
        tenv = make_torch_env(name)
        assert tenv.observation_space.shape == np_env.observation_space.shape
        assert type(tenv.action_space) is type(np_env.action_space)
    torch_env.register_torch_env("TinyCartPole", lambda: TorchCartPole(max_episode_steps=3))
    try:
        assert make_torch_env("TinyCartPole").max_episode_steps == 3
    finally:
        torch_env._TORCH_ENV_REGISTRY.pop("TinyCartPole")
