"""The port's RLlib core and PPO (`ray_tpu_torch/rllib/`) against the JAX
reference's (`ray_tpu/rllib/`): the same numpy inputs — observations,
batches, and the reference's params carried across by `params_from_numpy` —
through both give the same envs' trajectories, module outputs, encoder
outputs and gradients, advantages, optimizer steps, PPO losses, gradients
and updates (given the minibatch permutations JAX drew), and greedy returns.
Then the port alone: sampling against softmax(logits), PPO CartPole on the
CPU at the reference test's gate, save/restore, Pendulum, and remote env
runners and a remote learner in one cluster."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import ppo as ref_ppo
from ray_tpu.rllib.core import catalog as ref_catalog
from ray_tpu.rllib.core import rl_module as ref_mod
from ray_tpu.rllib.env import make_env as ref_make_env
from ray_tpu.rllib.env import register_env as ref_register_env
from ray_tpu.rllib.env.cartpole import VectorCartPole as RefCartPole
from ray_tpu.rllib.env.env_runner import EnvRunner as RefEnvRunner
from ray_tpu.rllib.utils import gae as ref_gae
from ray_tpu_torch.rllib import PPOConfig, make_env, register_env
from ray_tpu_torch.rllib.algorithms import ppo
from ray_tpu_torch.rllib.core import catalog, rl_module
from ray_tpu_torch.rllib.env.cartpole import VectorCartPole
from ray_tpu_torch.rllib.env.env_runner import EnvRunner
from ray_tpu_torch.rllib.utils import gae, optim
from ray_tpu_torch.rllib.utils.tree import tree_leaves, tree_map

TOL = 1e-6          # one forward, GAE, five optimizer steps
UPDATE_TOL = 1e-5   # a whole PPO update (12 minibatch steps)
GRAD_TOL = 1e-5     # gradients, relative to each tensor's largest entry


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    """Each leaf within tol·(1 + max|want|) of the reference's leaf."""
    got_l = [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x) for x in tree_leaves(got)]
    want_l = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = np.abs(g.astype(np.float64) - w).max() if w.size else 0.0
        assert err <= tol * (1 + np.abs(w).max()), f"{what} leaf {i}: {err}"


# ---------------------------------------------------------------- envs
@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1", "MultiCartPole"])
def test_envs_give_the_references_trajectories(name):
    env, ref_env = make_env(name, 4), ref_make_env(name, 4)
    o1, _ = env.reset(seed=3)
    o2, _ = ref_env.reset(seed=3)
    np.testing.assert_array_equal(o1, o2)
    rng = np.random.default_rng(0)
    for _ in range(300):
        if name == "Pendulum-v1":
            a = rng.uniform(-2, 2, (4, 1)).astype(np.float32)
        else:
            a = rng.integers(0, 2, env.num_envs)
        out, ref_out = env.step(a), ref_env.step(a)
        for x, y in zip(out[:4], ref_out[:4]):
            np.testing.assert_array_equal(x, y)
        assert out[4]["episode_returns"] == ref_out[4]["episode_returns"]


# ------------------------------------------------------------- modules
MODULES = {
    "discrete": (lambda: ref_mod.DiscretePolicyModule(4, 3, (16, 8)),
                 lambda: rl_module.DiscretePolicyModule(4, 3, (16, 8)), 4),
    "gaussian": (lambda: ref_mod.GaussianPolicyModule(3, 2, (16,)),
                 lambda: rl_module.GaussianPolicyModule(3, 2, (16,)), 3),
    "q": (lambda: ref_mod.QModule(5, 4, (8, 8)), lambda: rl_module.QModule(5, 4, (8, 8)), 5),
    "discrete_cnn": (
        lambda: ref_mod.DiscretePolicyModule(6 * 6 * 2, 3, model={"encoder": "cnn", "obs_shape": (6, 6, 2),
                                                                   "conv_filters": [(4, 3, 1), (4, 2, 2)],
                                                                   "encoder_out": 8}),
        lambda: rl_module.DiscretePolicyModule(6 * 6 * 2, 3, model={"encoder": "cnn", "obs_shape": (6, 6, 2),
                                                                    "conv_filters": [(4, 3, 1), (4, 2, 2)],
                                                                    "encoder_out": 8}),
        72),
}


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_modules_match_the_references_from_carried_params(kind):
    make_ref, make_port, obs_dim = MODULES[kind]
    ref, mod = make_ref(), make_port()
    params = _np(ref.init(jax.random.PRNGKey(1)))
    if kind == "gaussian":
        params["log_std"] = np.array([-0.3, 0.2], np.float32)
    tparams = rl_module.params_from_numpy(params, "cpu")
    assert tparams["pi" if kind != "q" else "q"][0]["w"].dtype == torch.float32
    obs = np.random.default_rng(2).standard_normal((7, obs_dim)).astype(np.float32)
    want = ref.forward(params, jnp.asarray(obs))
    got = mod.forward(tparams, torch.from_numpy(obs))
    _close(got, want, TOL, "forward")
    if kind == "q":
        return
    dist, ref_dist = got[0], want[0]
    if kind == "gaussian":
        actions = np.random.default_rng(3).standard_normal((7, 2)).astype(np.float32)
        t_act = torch.from_numpy(actions)
    else:
        actions = np.random.default_rng(3).integers(0, 3, 7).astype(np.int32)
        t_act = torch.from_numpy(actions)
    _close(mod.log_prob(dist, t_act), ref.log_prob(ref_dist, jnp.asarray(actions)), TOL, "log_prob")
    _close(mod.entropy(dist), ref.entropy(ref_dist), TOL, "entropy")
    _close(mod.greedy(dist), ref.greedy(ref_dist), TOL if kind == "gaussian" else 0.0, "greedy")


def test_categorical_sampling_follows_softmax():
    logits = torch.tensor([[0.5, -1.0, 1.5]])
    gen = torch.Generator().manual_seed(0)
    n = 30000
    draws = rl_module.DiscretePolicyModule.sample(gen, logits.expand(n, 3))
    counts = np.bincount(draws.numpy(), minlength=3)
    expect = n * torch.softmax(logits, -1)[0].numpy()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 13.82, (counts, expect)  # χ² with 2 degrees of freedom, p = 0.001
    # The same generator state draws the same actions.
    again = rl_module.DiscretePolicyModule.sample(torch.Generator().manual_seed(0), logits.expand(n, 3))
    assert torch.equal(draws, again)


# -------------------------------------------------------------- catalog
ENCODERS = {
    "mlp": ({"encoder": "mlp", "hidden": (16, 8), "activation": "gelu"}, (5, 6)),
    "cnn": ({"encoder": "cnn", "obs_shape": (16, 16, 3)}, (4, 16 * 16 * 3)),
    "lstm": ({"encoder": "lstm", "lstm_cell_size": 8}, (3, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoders_forward_and_gradients_match_the_references(name):
    cfg, shape = ENCODERS[name]
    obs_dim = shape[-1]
    ref_enc, enc = ref_catalog.build_encoder(cfg, obs_dim), catalog.build_encoder(cfg, obs_dim)
    assert enc.out_dim == ref_enc.out_dim
    params = _np(ref_enc.init(jax.random.PRNGKey(4)))
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want, ref_grads = jax.value_and_grad(lambda p: jnp.sum(jnp.sin(ref_enc.apply(p, jnp.asarray(x)))))(params)
    tparams = tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
    got = torch.sum(torch.sin(enc.apply(tparams, torch.from_numpy(x))))
    grads = torch.autograd.grad(got, tree_leaves(tparams))
    _close(got, want, TOL, "forward")
    _close(list(grads), jax.tree.leaves(ref_grads), GRAD_TOL, "grads")
    # Shapes of the port's own init equal the reference's.
    own = enc.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [a.shape for a in jax.tree.leaves(params)]


def test_lstm_step_equals_the_loop():
    enc = catalog.build_encoder({"encoder": "lstm", "lstm_cell_size": 8}, 6)
    params = enc.init(torch.Generator().manual_seed(1))
    x = torch.randn(3, 7, 6, generator=torch.Generator().manual_seed(2))
    state = enc.initial_state(3)
    for t in range(7):
        h, state = enc.step(params, x[:, t], state)
    assert torch.equal(h, enc.apply(params, x))


def test_orthogonal_init_is_orthogonal_and_seeded():
    w = catalog.orthogonal(torch.Generator().manual_seed(0), (3, 3, 2, 8), 2.0)
    flat = w.reshape(-1, 8)
    torch.testing.assert_close(flat.T @ flat, 4.0 * torch.eye(8), atol=1e-5, rtol=0)
    assert torch.equal(w, catalog.orthogonal(torch.Generator().manual_seed(0), (3, 3, 2, 8), 2.0))


# ------------------------------------------------------------------ GAE
def _batch(T=16, B=8, obs_dim=4, n_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((T, B, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, n_actions, (T, B)).astype(np.int32),
        "logp": (np.log(1 / n_actions) + 0.1 * rng.standard_normal((T, B))).astype(np.float32),
        "values": rng.standard_normal((T, B)).astype(np.float32),
        "rewards": rng.uniform(0, 1, (T, B)).astype(np.float32),
        "dones": (rng.uniform(size=(T, B)) < 0.1).astype(np.float32),
        "last_obs": rng.standard_normal((B, obs_dim)).astype(np.float32),
    }


def test_compute_gae_matches_the_references():
    ref = ref_mod.DiscretePolicyModule(4, 3, (16,))
    params = _np(ref.init(jax.random.PRNGKey(0)))
    batch = _batch()
    want = ref_gae.compute_gae(ref, params, jax.tree.map(jnp.asarray, batch), 0.99, 0.95)
    mod = rl_module.DiscretePolicyModule(4, 3, (16,))
    got = gae.compute_gae(mod, rl_module.params_from_numpy(params, "cpu"),
                          {k: torch.from_numpy(v) for k, v in batch.items()}, 0.99, 0.95)
    _close(list(got), list(want), TOL, "gae")
    flat = gae.flatten_time_major({k: torch.from_numpy(v) for k, v in batch.items()}, *got)
    ref_flat = ref_gae.flatten_time_major(jax.tree.map(jnp.asarray, batch), *want)
    assert sorted(flat) == sorted(ref_flat)
    _close([flat[k] for k in sorted(flat)], [ref_flat[k] for k in sorted(ref_flat)], TOL, "flat")


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("kind", ["clip_adam", "rmsprop"])
def test_optimizer_matches_optax(kind):
    if kind == "clip_adam":
        ref_opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-3))
        opt = optim.chain(optim.clip_by_global_norm(0.5), optim.adam(3e-3))
    else:
        ref_opt = optax.rmsprop(3e-3, decay=0.99, eps=0.1)
        opt = optim.rmsprop(3e-3, decay=0.99, eps=0.1)
    rng = np.random.default_rng(0)
    params = {"pi": [{"w": rng.standard_normal((4, 3)).astype(np.float32),
                      "b": np.zeros(3, np.float32)}], "log_std": np.zeros(2, np.float32)}
    ref_p, ref_s = params, ref_opt.init(params)
    p = rl_module.params_from_numpy(params, "cpu")
    s = opt.init(p)
    # Steps 0-3 have norms above the clip, step 4 below it.
    for step, scale in enumerate([3.0, 1.0, 10.0, 0.7, 0.01]):
        grads = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
        if kind == "clip_adam" and step == 4:
            assert float(optax.global_norm(grads)) < 0.5
        upd, ref_s = ref_opt.update(grads, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        tupd, s = opt.update(rl_module.params_from_numpy(grads, "cpu"), s, p)
        p = optim.apply_updates(p, tupd)
        _close(p, ref_p, TOL, f"params after step {step}")


def test_make_optimizer_follows_the_config():
    cfg = PPOConfig()
    cfg.grad_clip = None
    assert len(optim.make_optimizer(cfg).init({"w": torch.zeros(2)})) == 1
    cfg.grad_clip = 0.5
    assert len(optim.make_optimizer(cfg, "rmsprop").init({"w": torch.zeros(2)})) == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer(cfg, "sgd")


# ------------------------------------------------------------------ PPO
def _ppo_cfg(**kw):
    cfg = ref_ppo.PPOConfig()
    cfg.num_epochs, cfg.minibatch_size, cfg.entropy_coeff = 3, 32, 0.01
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _jax_perms(key, N, cfg):
    """The permutations the reference's update draws from `key`
    (`ray_tpu/rllib/algorithms/ppo.py:125-130`)."""
    mb = min(cfg.minibatch_size, N)
    nmb = max(N // mb, 1)
    return np.stack([np.asarray(jax.random.permutation(k, N)[: nmb * mb]).reshape(nmb, mb)
                     for k in jax.random.split(key, cfg.num_epochs)])


def _grads_in_state_jax():
    """An optimizer whose state after an update is the gradient it got (and
    which leaves params alone): reads the reference's gradients out of its
    jitted update."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _grads_in_state_port():
    return optim.GradientTransformation(lambda p: tree_map(torch.zeros_like, p),
                                        lambda g, s, p=None: (tree_map(torch.zeros_like, g), g))


@pytest.mark.parametrize("kind", ["discrete", "gaussian"])
def test_ppo_loss_and_gradients_match_the_references(kind):
    """One epoch of one minibatch: the metrics are the loss terms, and the
    optimizer's state is the gradient."""
    cfg = _ppo_cfg(num_epochs=1, minibatch_size=128)
    batch = _batch()
    if kind == "gaussian":
        ref, mod = ref_mod.GaussianPolicyModule(4, 2, (16,)), rl_module.GaussianPolicyModule(4, 2, (16,))
        batch["actions"] = np.random.default_rng(9).standard_normal((16, 8, 2)).astype(np.float32)
    else:
        ref, mod = ref_mod.DiscretePolicyModule(4, 3, (16,)), rl_module.DiscretePolicyModule(4, 3, (16,))
    params = _np(ref.init(jax.random.PRNGKey(0)))
    if kind == "gaussian":
        params["log_std"] = np.array([-0.2, 0.3], np.float32)
    key = jax.random.PRNGKey(5)
    (_, ref_grads), ref_m = jax.jit(ref_ppo.make_ppo_update(ref, _grads_in_state_jax(), cfg))(
        (params, jax.tree.map(jnp.zeros_like, params)), jax.tree.map(jnp.asarray, batch), key)
    update = ppo.make_ppo_update(mod, _grads_in_state_port(), cfg)
    tparams = rl_module.params_from_numpy(params, "cpu")
    (new_params, grads), m = update.with_perms(
        (tparams, tree_map(torch.zeros_like, tparams)), {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(_jax_perms(key, 128, cfg)))
    assert sorted(m) == sorted(ref_m)
    _close([m[k] for k in ref_m], [ref_m[k] for k in ref_m], UPDATE_TOL, "loss terms")
    _close(grads, ref_grads, GRAD_TOL, "grads")
    _close(new_params, params, 0.0, "params unchanged")


@pytest.mark.parametrize("kind", ["discrete", "gaussian"])
def test_ppo_update_matches_the_references_given_its_permutations(kind):
    cfg = _ppo_cfg()
    batch = _batch()
    if kind == "gaussian":
        ref, mod = ref_mod.GaussianPolicyModule(4, 2, (16,)), rl_module.GaussianPolicyModule(4, 2, (16,))
        batch["actions"] = np.random.default_rng(9).standard_normal((16, 8, 2)).astype(np.float32)
    else:
        ref, mod = ref_mod.DiscretePolicyModule(4, 3, (16,)), rl_module.DiscretePolicyModule(4, 3, (16,))
    from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer

    params = _np(ref.init(jax.random.PRNGKey(0)))
    ref_opt, opt = ref_make_optimizer(cfg), optim.make_optimizer(cfg)
    key = jax.random.PRNGKey(11)
    (ref_p, ref_s), ref_m = jax.jit(ref_ppo.make_ppo_update(ref, ref_opt, cfg))(
        (params, ref_opt.init(params)), jax.tree.map(jnp.asarray, batch), key)
    tparams = rl_module.params_from_numpy(params, "cpu")
    update = ppo.make_ppo_update(mod, opt, cfg)
    perms = torch.from_numpy(_jax_perms(key, 128, cfg))
    assert perms.shape == (3, 4, 32)
    (p, s), m = update.with_perms((tparams, opt.init(tparams)), {k: torch.from_numpy(v) for k, v in batch.items()},
                                  perms)
    _close(p, ref_p, UPDATE_TOL, "params")
    _close([m[k] for k in ref_m], [ref_m[k] for k in ref_m], UPDATE_TOL, "metrics")
    assert int(s[1].count) == int(ref_s[1][0].count) == 12


def test_ppo_perms_tile_each_epoch():
    perms = optim.minibatch_perms(torch.Generator().manual_seed(0), 100, 3, 3, 32)
    assert perms.shape == (3, 3, 32) and perms.dtype == torch.int64
    for e in perms:
        flat = e.reshape(-1)
        assert len(set(flat.tolist())) == 96 and flat.max() < 100


def test_podracer_and_mesh_paths_raise_until_ported():
    """The update across several cards (a pmean: Anakin over devices) and
    the learner over a mesh raise; Anakin over more devices than there are
    raises the reference's ValueError before it reaches the update."""
    with pytest.raises(NotImplementedError, match="item 6"):
        ppo.make_ppo_update(rl_module.DiscretePolicyModule(4, 2), None, PPOConfig(), axis_name="d")
    with pytest.raises(ValueError, match="available devices 1"):
        PPOConfig().environment("CartPole-v1").podracer("anakin", num_devices=2).resources(device="cpu").build()
    from ray_tpu_torch.rllib.core.learner import Learner

    with pytest.raises(NotImplementedError, match="item 4"):
        Learner(rl_module.DiscretePolicyModule(4, 2), None, mesh=object(), device="cpu")


# --------------------------------------------------------------- runner
class _SeededCartPole:
    """CartPole whose unseeded resets draw from a fixed seed (evaluate()
    resets its fresh env without one)."""

    def __init__(self, cls):
        self.cls = cls

    def __call__(self, num_envs, **kw):
        env = self.cls(num_envs, **kw)
        env._rng = np.random.default_rng(123)
        return env


register_env("SeededCartPole", _SeededCartPole(VectorCartPole))
ref_register_env("SeededCartPole", _SeededCartPole(RefCartPole))


def test_greedy_evaluate_gives_the_references_returns():
    ref = ref_mod.DiscretePolicyModule(4, 2, (16,))
    params = jax.tree.map(np.array, ref.init(jax.random.PRNGKey(2)))
    # A policy that pushes toward the pole's lean, so episodes run for a while.
    params["pi"][0]["w"][2:, 0] += np.array([5.0, 1.0], np.float32)
    params["pi"][1]["w"][0] += np.array([-5.0, 5.0], np.float32)
    ref_runner = RefEnvRunner(env_name="SeededCartPole", num_envs=4, module=ref, rollout_len=8, seed=0)
    runner = EnvRunner(env_name="SeededCartPole", num_envs=4, module=rl_module.DiscretePolicyModule(4, 2, (16,)),
                       rollout_len=8, seed=0, device="cpu")
    want = ref_runner.evaluate(params, num_episodes=6)
    got = runner.evaluate(params, num_episodes=6)
    assert got == want and want["episode_reward_mean"] > 20, (got, want)


def test_sample_logp_is_the_log_prob_of_the_chosen_actions():
    mod = rl_module.DiscretePolicyModule(4, 2, (16,))
    runner = EnvRunner(env_name="CartPole-v1", num_envs=8, module=mod, rollout_len=32, seed=0, device="cpu")
    params = mod.init(torch.Generator().manual_seed(0))
    out = runner.sample(rl_module.params_from_numpy(tree_map(lambda t: t.numpy(), params), "cpu"))
    assert out["obs"].shape == (32, 8, 4) and out["actions"].dtype == np.int32
    logits, value = mod.forward(params, torch.from_numpy(out["obs"]))
    want = mod.log_prob(logits, torch.from_numpy(out["actions"]))
    np.testing.assert_allclose(out["logp"], want.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out["values"], value.detach().numpy(), rtol=1e-6, atol=1e-6)
    # The bootstrap view is the next fragment's first observation.
    nxt = runner.sample(params)
    np.testing.assert_array_equal(out["last_obs"], nxt["obs"][0])


def test_runner_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnvRunner(env_name="CartPole-v1", num_envs=2, module=rl_module.DiscretePolicyModule(4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPOConfig().environment("CartPole-v1").training(train_batch_size=64, minibatch_size=32).build()


# ------------------------------------------------------------ algorithm
def test_ppo_cartpole_learns_on_the_cpu():
    """BASELINE config #1 at the reference test's settings and gate
    (`tests/test_rllib.py:36-53`): reward 150 within 25 iterations."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=16)
        .training(train_batch_size=2048, minibatch_size=256, num_epochs=10, lr=3e-4, entropy_coeff=0.01)
        .debugging(seed=0)
        .resources(device="cpu")
        .build()
    )
    best = 0.0
    for _ in range(25):
        result = algo.train()
        best = max(best, result["episode_reward_mean"])
        if best >= 150:
            break
    algo.stop()
    assert best >= 150, f"PPO failed to learn CartPole: best={best}"
    assert result["timesteps_total"] <= 100_000


def test_save_restore_is_bit_equal(tmp_path):
    config = (
        PPOConfig().environment("CartPole-v1")
        .training(train_batch_size=256, minibatch_size=64, num_epochs=2).resources(device="cpu")
    )
    algo = config.build()
    algo.train()
    ckpt = algo.save(str(tmp_path / "ckpt"))
    w_before = algo.learner_group.get_weights()
    algo2 = config.copy().build()
    algo2.restore(ckpt)
    for a, b in zip(tree_leaves(w_before), tree_leaves(algo2.learner_group.get_weights())):
        np.testing.assert_array_equal(a, b)
    assert algo2.iteration == algo.iteration
    # The restored learner continues as the saved one would: same draws.
    r1, r2 = algo.learner_group.local_learner, algo2.learner_group.local_learner
    assert torch.equal(r1._gen.get_state(), r2._gen.get_state())
    algo.stop()
    algo2.stop()


def test_continuous_actions_pendulum():
    algo = (
        PPOConfig().environment("Pendulum-v1")
        .training(train_batch_size=512, minibatch_size=128, num_epochs=2).resources(device="cpu").build()
    )
    result = algo.train()
    assert np.isfinite(result["info"]["learner"]["total_loss"])
    assert result["num_env_steps_sampled_this_iter"] == 512
    algo.stop()


@pytest.mark.cluster
def test_remote_env_runners_and_remote_learner():
    """Two CPU-actor env runners and a remote learner (a CPU worker here; a
    GPU worker when the learner's device is the card) in one cluster."""
    rt.init(num_cpus=4)
    try:
        algo = (
            PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4)
            .training(train_batch_size=512, minibatch_size=128, num_epochs=2)
            .resources(device="cpu", remote_learner=True)
            .build()
        )
        try:
            result = algo.train()
            assert result["num_env_steps_sampled_this_iter"] == 512
            assert np.isfinite(result["info"]["learner"]["total_loss"])
            assert algo.learner_group.local_learner is None
            w = algo.learner_group.get_weights()
            assert isinstance(w["pi"][0]["w"], np.ndarray)
        finally:
            algo.stop()
    finally:
        rt.shutdown()
