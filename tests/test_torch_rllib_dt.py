"""The port's Decision Transformer (`ray_tpu_torch/rllib/algorithms/dt.py`)
against the JAX reference's (`ray_tpu/rllib/algorithms/dt.py`): the
episode data DT reads (`EpisodeDataset`, `collect_episodes`) equal the
reference's; the reference's params, carried across by
`params_from_numpy`, give the same action logits, the same loss terms and
state after one update given the permutations JAX drew (fed through
`update.with_perms`), and the same history-conditioned evaluation returns.
Then the reference's own unmarked tests (`tests/test_rllib_dt.py:16-45,70-76`)
on the port, and two iterations of the algorithm.

Tolerances: TOL (1e-5, of each leaf's largest entry) for the logits, the
loss terms and the state after an update."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import dt as ref_dt
from ray_tpu.rllib.offline import collect_episodes as ref_collect_episodes
from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer
from ray_tpu_torch.rllib import DTConfig
from ray_tpu_torch.rllib.algorithms import dt
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.offline import EpisodeDataset, collect_episodes
from ray_tpu_torch.rllib.utils import optim
from torch_rl import close, jax_perms, metrics_close, to_jax, to_torch

TOL = 1e-5


def _expert(obs: np.ndarray) -> np.ndarray:
    theta, theta_dot = obs[:, 2], obs[:, 3]
    return (theta + 0.5 * theta_dot > 0).astype(np.int64)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _cfg(config_cls, **kw):
    cfg = config_cls()
    cfg.context_length, cfg.embed_dim, cfg.num_layers, cfg.num_heads = 6, 16, 2, 2
    cfg.train_batch_size, cfg.minibatch_size, cfg.num_epochs = 16, 8, 2
    cfg.max_ep_len, cfg.target_return = 40, 60.0
    for name, value in kw.items():
        setattr(cfg, name, value)
    return cfg


def _modules(cfg_ref, cfg_port):
    return ref_dt.DTModule(4, 2, cfg_ref), dt.DTModule(4, 2, cfg_port)


def _batch(ds, cfg, seed=0):
    batch = ds.sample_subsequences(np.random.default_rng(seed), cfg.train_batch_size, cfg.context_length)
    batch["rtg"] = batch["rtg"] / cfg.rtg_scale
    batch["actions"] = batch["actions"].astype(np.int32)
    return batch


# ------------------------------------------------------------------ data
@pytest.fixture(scope="module")
def demos():
    return collect_episodes("CartPole-v1", _expert, n_episodes=4, seed=0, max_steps=60)


def test_collect_and_rtg(demos):
    ds = demos
    assert len(ds) == 4
    ep, rtg = ds.episodes[0], ds._rtg[0]
    # Undiscounted RTG: rtg[t] = sum of rewards from t on.
    np.testing.assert_allclose(rtg[0], ep["rewards"].sum())
    np.testing.assert_allclose(rtg[-1], ep["rewards"][-1])
    # Every field DT reads is the reference's: the episodes, their RTGs and returns.
    ref = ref_collect_episodes("CartPole-v1", _expert, n_episodes=4, seed=0, max_steps=60)
    for got, want in zip(ds.episodes, ref.episodes):
        assert sorted(got) == sorted(want) == ["actions", "obs", "rewards"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    for got, want in zip(ds._rtg, ref._rtg):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ds.returns, ref.returns)


def test_subsequence_shapes_and_padding():
    ds = collect_episodes("CartPole-v1", _expert, n_episodes=3, seed=1, max_steps=30)
    rng = np.random.default_rng(0)
    batch = ds.sample_subsequences(rng, 16, K=20)
    assert batch["obs"].shape == (16, 20, 4)
    assert batch["mask"].shape == (16, 20)
    # Front padding: once the mask turns on it stays on.
    for m in batch["mask"]:
        on = np.flatnonzero(m)
        assert len(on) >= 1 and np.all(np.diff(on) == 1) and on[-1] == 19
    # The same windows as the reference's from the same generator.
    ref = ref_collect_episodes("CartPole-v1", _expert, n_episodes=3, seed=1, max_steps=30)
    want = ref.sample_subsequences(np.random.default_rng(0), 16, K=20)
    assert sorted(batch) == sorted(want) == ["actions", "mask", "obs", "rtg", "timesteps"]
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
        assert batch[k].dtype == want[k].dtype


def test_empty_rejected():
    with pytest.raises(ValueError):
        EpisodeDataset([])


def test_dt_requires_dataset_and_target():
    with pytest.raises(ValueError, match="offline_data"):
        DTConfig().environment("CartPole-v1").training(target_return=100.0).resources(device="cpu").build()
    demos = collect_episodes("CartPole-v1", _expert, n_episodes=2, seed=0, max_steps=20)
    with pytest.raises(ValueError, match="target_return"):
        DTConfig().environment("CartPole-v1").offline_data(demos).resources(device="cpu").build()
    with pytest.raises(ValueError, match="minibatches"):
        (DTConfig().environment("CartPole-v1").training(target_return=10.0, train_batch_size=10, minibatch_size=4)
         .offline_data(demos).resources(device="cpu").build())


# ------------------------------------------------------------------ model
def test_dt_forward_matches_the_references(demos):
    ref, mod = _modules(_cfg(ref_dt.DTConfig), _cfg(DTConfig))
    params = _np(ref.init(jax.random.PRNGKey(0)))
    # The same tree as the port's own init.
    own = mod.init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, {k: v for k, v in own.items()}))
    assert [a.shape for a in jax.tree.leaves(params)] == [tuple(t.shape) for t in jax.tree.leaves(own)]
    batch = _batch(demos, _cfg(DTConfig))
    batch["timesteps"][0, -1] = 57  # past max_ep_len: JAX's gather clamps to the last row
    want = ref.forward(to_jax(params), *(jax.numpy.asarray(batch[k]) for k in ("rtg", "obs", "actions", "timesteps")))
    got = mod.forward(rl_module.params_from_numpy(params, "cpu"),
                      *(torch.from_numpy(batch[k]) for k in ("rtg", "obs", "actions", "timesteps")))
    assert got.shape == (16, 6, 2)
    close(got, want, TOL, "logits")


def test_dt_update_matches_the_references_given_its_permutations(demos):
    cfg_ref, cfg_port = _cfg(ref_dt.DTConfig), _cfg(DTConfig)
    ref, mod = _modules(cfg_ref, cfg_port)
    params = _np(ref.init(jax.random.PRNGKey(1)))
    batch = _batch(demos, cfg_port, seed=2)
    assert batch["timesteps"].max() >= cfg_port.max_ep_len  # rows read past the table: no gradient
    ref_opt, opt = ref_make_optimizer(cfg_ref), optim.make_optimizer(cfg_port)
    key = jax.random.PRNGKey(9)
    (ref_p, ref_s), ref_m = jax.jit(ref_dt.make_dt_update(ref, ref_opt, cfg_ref))(
        (params, ref_opt.init(params)), to_jax(batch), key)
    perms = jax_perms(key, cfg_port.train_batch_size, cfg_port.num_epochs, cfg_port.minibatch_size)
    tparams = rl_module.params_from_numpy(params, "cpu")
    (p, s), m = dt.make_dt_update(mod, opt, cfg_port).with_perms((tparams, opt.init(tparams)), to_torch(batch),
                                                                 torch.from_numpy(perms))
    assert sorted(m) == ["action_accuracy", "dt_loss"]
    metrics_close(m, ref_m, TOL, "loss terms")
    close(p, ref_p, TOL, "params")
    close(s, ref_s, TOL, "optimizer state")
    assert int(s[1].count) == int(ref_s[1][0].count) == perms.shape[0] * perms.shape[1] == 4


# ------------------------------------------------------------------ algorithm
def _algos(demos):
    ref_demos = ref_collect_episodes("CartPole-v1", _expert, n_episodes=4, seed=0, max_steps=60)
    ref_algo = _cfg(ref_dt.DTConfig).environment("CartPole-v1").offline_data(ref_demos).build()
    algo = _cfg(DTConfig).environment("CartPole-v1").offline_data(demos).resources(device="cpu").build()
    return ref_algo, algo


def test_dt_evaluation_returns_equal_the_references(demos):
    """The history-conditioned rollouts (env seeds 1000 + episode) with the
    reference's weights, once as initialised and once after its update: the
    same actions, so the same returns and lengths."""
    ref_algo, algo = _algos(demos)
    try:
        for trained in (False, True):
            if trained:
                ref_algo.train()
            algo._weights = _np(ref_algo._weights)
            want = ref_algo.evaluate(n_episodes=2)
            got = algo.evaluate(n_episodes=2)
            assert got == want, (trained, got, want)
    finally:
        ref_algo.stop()
        algo.stop()


def test_two_iterations_of_the_algorithm(demos):
    algo = _cfg(DTConfig).environment("CartPole-v1").offline_data(demos).resources(device="cpu").build()
    try:
        results = [algo.train() for _ in range(2)]
    finally:
        algo.stop()
    assert [r["num_offline_transitions_this_iter"] for r in results] == [16, 16]
    assert all(r["num_env_steps_sampled_this_iter"] == 0 for r in results)
    assert all(np.isfinite(r["info"]["learner"]["dt_loss"]) for r in results)
    ev = results[-1]["evaluation"]
    assert ev["episodes_this_eval"] == 5 and 0 < ev["episode_len_mean"] <= 39
    assert results[-1]["episode_reward_mean"] == pytest.approx(np.mean([r["evaluation"]["episode_reward_mean"]
                                                                       for r in results]))
