"""The port's Anakin plane (`ray_tpu_torch/rllib/podracer/anakin.py`): the
config surface, one fused step against the reference's
`make_anakin_step` (jitted on the CPU) given JAX's draws and permutations,
training through `Algorithm.train()` with a save -> restore round trip, the
reference test's learning bar, and the device check.

The reference's step draws everything from one key (`anakin.py:43-50`):
`k_roll, k_up = split(rng)`; `split(k_roll, T)`; at each step `k_act,
k_reset = split(key)`, the action from `k_act` (`jax.random.categorical`,
exactly argmax(logits + `jax.random.gumbel(k_act, logits.shape)`); or the
mean plus exp(log_std) times `jax.random.normal(k_act, mean.shape)`), the
resets from `k_reset`; the update's permutations from `k_up`. The test
replays those splits to build the port's draws: the action noise, the unit
uniforms of each reset, the permutations."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import ppo as ref_ppo
from ray_tpu.rllib.core import rl_module as ref_mod
from ray_tpu.rllib.podracer import anakin as ref_anakin
from ray_tpu.rllib.podracer import jax_env
from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer
from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.algorithms import ppo
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.podracer.anakin import make_anakin_step
from ray_tpu_torch.rllib.podracer.torch_env import make_torch_env
from ray_tpu_torch.rllib.utils import optim
from ray_tpu_torch.rllib.utils.tree import tree_leaves

from torch_rl import close, jax_perms, metrics_close, to_torch

TOL = 1e-6          # the trajectory: one forward and one env step at a time
UPDATE_TOL = 1e-5   # params and metrics after the update


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _anakin_cfg(**over):
    base = dict(num_envs=32, rollout_len=16)
    base.update(over)
    return (
        PPOConfig()
        .environment("CartPole-v1")
        .training(
            train_batch_size=base["num_envs"] * base["rollout_len"],
            minibatch_size=base["num_envs"] * base["rollout_len"] // 2,
            num_epochs=2,
            lr=1e-3,
        )
        .debugging(seed=7)
        .podracer("anakin", **base)
        .resources(device="cpu")
    )


def test_config_surface_and_validation():
    cfg = _anakin_cfg()
    assert cfg.podracer_plane == "anakin"
    assert cfg.podracer_num_envs == 32
    assert cfg.derived_podracer_rollout_len() == 16

    # rollout_len derives from train_batch_size when unset.
    cfg2 = PPOConfig().environment("CartPole-v1").training(train_batch_size=2048).podracer("anakin", num_envs=64)
    assert cfg2.derived_podracer_rollout_len() == 2048 // 64

    with pytest.raises(ValueError, match="plane"):
        PPOConfig().environment("CartPole-v1").podracer("naboo").validate()

    # Anakin demands a functional env; the error routes users to Sebulba.
    bad = PPOConfig().environment("MultiCartPole").podracer("anakin")
    with pytest.raises(ValueError, match="[Ss]ebulba"):
        bad.validate()
    for bad in (dict(num_actors=0), dict(num_actors=1, min_actors=2)):
        with pytest.raises(ValueError, match="actors"):
            PPOConfig().environment("CartPole-v1").podracer("sebulba", **bad).validate()


def _jax_draws(rng, T: int, B: int, env_name: str, act_dim: int):
    """The reference's keys for one fused step, replayed: each step's action
    noise and reset unit uniforms, and the update's key."""
    k_roll, k_up = jax.random.split(rng)
    noise, reset = [], []
    for key in jax.random.split(k_roll, T):
        k_act, k_reset = jax.random.split(key)
        if env_name == "CartPole-v1":
            noise.append(np.asarray(jax.random.gumbel(k_act, (B, act_dim))))
            reset.append(np.asarray(jax.random.uniform(k_reset, (B, 4))))
        else:
            noise.append(np.asarray(jax.random.normal(k_act, (B, act_dim))))
            k_th, k_dot = jax.random.split(k_reset)
            reset.append(np.stack([np.asarray(jax.random.uniform(k_th, (B,))),
                                   np.asarray(jax.random.uniform(k_dot, (B,)))], axis=1))
    return {"noise": torch.from_numpy(np.stack(noise)), "reset": torch.from_numpy(np.stack(reset))}, k_up


@pytest.mark.parametrize("env_name", ["CartPole-v1", "Pendulum-v1"])
def test_fused_step_matches_the_references_given_its_draws(env_name):
    T, B, hidden = 8, 16, (16,)
    cfg = ref_ppo.PPOConfig()
    cfg.num_epochs, cfg.minibatch_size, cfg.lr, cfg.entropy_coeff = 2, 64, 1e-3, 0.01
    jenv, tenv = jax_env.make_jax_env(env_name), make_torch_env(env_name)
    obs_dim = jenv.observation_space.shape[0]
    if env_name == "CartPole-v1":
        act_dim = jenv.action_space.n
        ref, mod = ref_mod.DiscretePolicyModule(obs_dim, act_dim, hidden), rl_module.DiscretePolicyModule(
            obs_dim, act_dim, hidden)
    else:
        act_dim = 1
        ref, mod = ref_mod.GaussianPolicyModule(obs_dim, 1, hidden), rl_module.GaussianPolicyModule(obs_dim, 1, hidden)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    env_state = jax_env.init_env_state(jenv, jax.random.PRNGKey(1), B)
    rng = jax.random.PRNGKey(3)

    # The reference's trajectory: its fused step with an update that hands
    # the batch back as its metrics.
    spy = ref_anakin.make_anakin_step(jenv, ref, lambda state, batch, key: (state, batch), T)
    _, ref_env_after, ref_batch, ref_eps = jax.jit(spy)((params, None), env_state, rng)
    ref_opt = ref_make_optimizer(cfg)
    ref_step = ref_anakin.make_anakin_step(jenv, ref, ref_ppo.make_ppo_update(ref, ref_opt, cfg), T)
    (ref_p, _), _, ref_m, _ = jax.jit(ref_step)((params, ref_opt.init(params)), env_state, rng)

    draws, k_up = _jax_draws(rng, T, B, env_name, act_dim)
    perms = torch.from_numpy(jax_perms(k_up, T * B, cfg.num_epochs, cfg.minibatch_size))
    opt = optim.make_optimizer(cfg)
    step = make_anakin_step(tenv, mod, ppo.make_ppo_update(mod, opt, cfg), T)
    tparams = rl_module.params_from_numpy(params, "cpu")
    test = to_torch(env_state)

    est, traj = step.rollout(tparams, test, draws)
    got_a, want_a = traj["actions"].numpy(), np.asarray(ref_batch["actions"])
    if env_name == "CartPole-v1":
        scores = np.sort(np.asarray(jax.vmap(lambda o: ref.forward(params, o)[0])(ref_batch["obs"]))
                         + draws["noise"].numpy(), axis=-1)
        gap = float((scores[..., -1] - scores[..., -2]).min())
        assert np.array_equal(got_a, want_a), f"actions differ; the nearest tie's gap {gap}"
        print(f"{env_name}: every action equal; the nearest tie's gap {gap:.3e}")
    else:
        close(traj["actions"], want_a, TOL, "actions")
    for k in ("obs", "logp", "values", "rewards", "dones", "last_obs"):
        close(traj[k], ref_batch[k], TOL, k)
    for k, v in ref_eps.items():
        close(traj["dones" if k == "done" else k], v, TOL, k)
    close([est[k] for k in sorted(est)], [ref_env_after[k] for k in sorted(ref_env_after)], TOL, "env state")

    (p, _), est2, m, _ = step.with_draws((tparams, opt.init(tparams)), test, draws, perms)
    close(p, ref_p, UPDATE_TOL, "params after the update")
    metrics_close(m, ref_m, UPDATE_TOL)
    close([est2[k] for k in sorted(est2)], [ref_env_after[k] for k in sorted(ref_env_after)], TOL, "env state")


def test_draws_follow_the_generator_in_order():
    """The step's own draws: action noise, then reset uniforms, then the
    permutations, from one generator; the same seed gives the same step."""
    cfg = ref_ppo.PPOConfig()
    cfg.num_epochs, cfg.minibatch_size = 2, 32
    env, mod = make_torch_env("CartPole-v1"), rl_module.DiscretePolicyModule(4, 2, (8,))
    opt = optim.make_optimizer(cfg)
    step = make_anakin_step(env, mod, ppo.make_ppo_update(mod, opt, cfg), 4)
    gen = torch.Generator().manual_seed(5)
    draws, perms = step.draw(gen, 8), step.perms(gen, 32)
    assert draws["noise"].shape == (4, 8, 2) and draws["reset"].shape == (4, 8, 4) and perms.shape == (2, 1, 32)
    params = mod.init(torch.Generator().manual_seed(0))
    env_state = {"core": torch.zeros(8, 4), "steps": torch.zeros(8, dtype=torch.int32), "ep_ret": torch.zeros(8)}
    want = step.with_draws((params, opt.init(params)), env_state, draws, perms)
    got = step((params, opt.init(params)), env_state, torch.Generator().manual_seed(5))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_anakin_trains_single_program_and_restores(tmp_path):
    algo = _anakin_cfg().build()
    try:
        assert algo.learner_group is None  # no classic learner stack built
        per_iter = 32 * 16
        seen = 0
        for _ in range(3):
            result = algo.train()
            seen += per_iter
            assert result["timesteps_total"] == seen
            info = result["info"]["learner"]
            for k in ("total_loss", "policy_loss", "vf_loss"):
                assert np.isfinite(info[k]), (k, info[k])
            assert result["info"]["fused_step_seconds"] > 0
        # The fused step also feeds episode stats from the done mask.
        assert result["episodes_this_iter"] > 0
        assert result["episode_reward_mean"] > 0
        ckpt = algo.save(str(tmp_path / "ck"))
        w0 = algo._weights
        nxt = algo.train()["info"]["learner"]
    finally:
        algo.stop()

    algo2 = _anakin_cfg().build()
    try:
        algo2.restore(ckpt)
        w1 = algo2._weights
        for a, b in zip(tree_leaves(w0), tree_leaves(w1)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # Restored plane keeps training (optimizer state and the generator
        # came along too: the update after the restore is the update after
        # the save, though the env states differ).
        again = algo2.train()["info"]["learner"]
        assert np.isfinite(again["total_loss"])
        assert algo2.iteration == 4 and algo2._timesteps_total == 4 * 32 * 16
        assert set(again) == set(nxt)
    finally:
        algo2.stop()


def test_anakin_learns_cartpole():
    cfg = _anakin_cfg(num_envs=64, rollout_len=32)
    cfg = cfg.training(train_batch_size=64 * 32, minibatch_size=512, num_epochs=4, lr=2.5e-3)
    algo = cfg.build()
    try:
        first = algo.train()["episode_reward_mean"]
        best = first
        for _ in range(14):
            best = max(best, algo.train()["episode_reward_mean"])
        assert best > max(2 * first, 50.0), (first, best)
    finally:
        algo.stop()


def test_more_devices_than_there_are_raises():
    with pytest.raises(ValueError, match="podracer_num_devices=4 > available devices 1"):
        _anakin_cfg(num_devices=4).build()


def test_importing_podracer_loads_neither_plane():
    code = ("import sys\nimport ray_tpu_torch.rllib.podracer as p\n"
            "print(sorted(m.rsplit('.', 1)[1] for m in sys.modules if m.startswith('ray_tpu_torch.rllib.podracer.')))\n"
            "p.AnakinDriver, p.SebulbaDriver\n"
            "print('ray_tpu_torch.rllib.podracer.anakin' in sys.modules, "
            "'ray_tpu_torch.rllib.podracer.sebulba' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["['torch_env']", "True True"]
