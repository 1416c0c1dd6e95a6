"""The port's multi-agent PPO (`ray_tpu_torch/rllib/env/ma_runner.py`,
`algorithms/multi_agent_ppo.py`) beside the reference's
(`tests/test_rllib_multiagent.py`): the runner splits batches per policy
with the reference's slot layout, self-play maps every agent to one
policy, and one PPO update of each policy on the same per-policy batch,
from the same params with the same permutations, equals the reference's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ray_tpu.rllib.algorithms import ppo as ref_ppo
from ray_tpu.rllib.algorithms.multi_agent_ppo import MultiAgentPPOConfig as RefMultiAgentPPOConfig
from ray_tpu.rllib.core import rl_module as ref_mod
from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer
from ray_tpu_torch.rllib.algorithms import ppo
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import MultiAgentPPOConfig
from ray_tpu_torch.rllib.core.rl_module import DiscretePolicyModule, params_from_numpy
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env.ma_runner import MultiAgentEnvRunner
from ray_tpu_torch.rllib.env.multi_agent import make_multi_agent
from ray_tpu_torch.rllib.utils.optim import make_optimizer
from ray_tpu_torch.rllib.utils.tree import tree_leaves

UPDATE_TOL = 1e-5


def _ma_cartpole(num_agents=2):
    return make_multi_agent(lambda n, **kw: make_env("CartPole-v1", n, **kw), num_agents)


def test_runner_splits_batches_per_policy():
    ctor = _ma_cartpole(3)
    probe = ctor()
    obs_dim = int(np.prod(probe.observation_space.shape))
    mods = {
        "even": DiscretePolicyModule(obs_dim, probe.action_space.n, (16,)),
        "odd": DiscretePolicyModule(obs_dim, probe.action_space.n, (16,)),
    }
    runner = MultiAgentEnvRunner(
        make_env=ctor, modules=mods,
        policy_mapping_fn=lambda a: "even" if int(a[-1]) % 2 == 0 else "odd",
        num_instances=2, rollout_len=8, seed=0, device="cpu",
    )
    params = {pid: m.init(torch.Generator().manual_seed(0)) for pid, m in mods.items()}
    out = runner.sample(params)
    stats = out.pop("__stats__")
    assert set(out) == {"even", "odd"}
    # 3 agents: agent_0/agent_2 -> even (2 slots/instance), agent_1 -> odd.
    assert out["even"]["obs"].shape[:2] == (8, 4)
    assert out["odd"]["obs"].shape[:2] == (8, 2)
    assert runner.slots == {"even": ["agent_0", "agent_2"], "odd": ["agent_1"]}
    for pid, b in out.items():
        for key in ("obs", "actions", "logp", "values", "rewards", "dones"):
            assert np.isfinite(np.asarray(b[key])).all(), key
        # Each policy's logp is its own module's log_prob of the actions it chose.
        logits, _ = mods[pid].forward(params[pid], torch.from_numpy(b["obs"]))
        want = mods[pid].log_prob(logits, torch.from_numpy(b["actions"]))
        np.testing.assert_allclose(b["logp"], want.detach().numpy(), rtol=1e-6, atol=1e-6)
        assert b["last_obs"].shape == b["obs"].shape[1:]
    assert "policy_episode_returns" in stats
    ev = runner.evaluate(params, 2)
    assert ev["episodes"] == 2 and np.isfinite(ev["episode_reward_mean"])


def test_self_play_weight_sharing():
    """shared_policy=True: every agent maps to ONE policy/parameter set."""
    cfg = (
        MultiAgentPPOConfig()
        .environment(ma_env_maker=_ma_cartpole(2))
        .training(train_batch_size=512, minibatch_size=128)
        .debugging(seed=0)
        .multi_agent(shared_policy=True)
        .resources(device="cpu")
    )
    cfg.num_instances = 4
    algo = cfg.build()
    assert list(algo.modules) == ["shared"]
    result = algo.train()
    assert np.isfinite(result["info"]["learner"]["shared"]["total_loss"])
    # Both agents ride the same batch: slots = instances × 2 agents.
    assert algo._runner.slots["shared"] == ["agent_0", "agent_1"]
    assert result["num_env_steps_sampled_this_iter"] == 512


def test_two_policies_train_apart_and_save_restore(tmp_path):
    cfg = (
        MultiAgentPPOConfig()
        .environment(ma_env_maker=_ma_cartpole(2))
        .training(train_batch_size=512, minibatch_size=128, num_epochs=2)
        .debugging(seed=0)
        .multi_agent(policies=["p0", "p1"], policy_mapping_fn=lambda a: "p0" if a == "agent_0" else "p1")
        .resources(device="cpu")
    )
    cfg.num_instances = 4
    algo = cfg.build()
    # Same seed, same init: the two policies start equal and part by training.
    w0 = algo.learner_group.get_weights()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(w0["p0"]), tree_leaves(w0["p1"])))
    for _ in range(2):
        result = algo.train()
    assert set(result["info"]["learner"]) == {"p0", "p1"}
    w = algo.learner_group.get_weights()
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(w["p0"]), tree_leaves(w["p1"])))
    algo.save(str(tmp_path))
    algo2 = cfg.copy().build()
    algo2.restore(str(tmp_path))
    for pid in ("p0", "p1"):
        for a, b in zip(tree_leaves(w[pid]), tree_leaves(algo2.learner_group.get_weights()[pid])):
            assert torch.equal(a, b)
    assert algo2.iteration == 2


def test_one_update_per_policy_matches_the_references():
    """Each policy's learner runs the reference's PPO update: from the same
    params, on its own batch, with the permutations JAX drew, the port's
    params and metrics equal the reference's."""
    ref_cfg, cfg = RefMultiAgentPPOConfig(), MultiAgentPPOConfig()
    for c in (ref_cfg, cfg):
        c.num_epochs, c.minibatch_size = 2, 16
    rng = np.random.default_rng(0)
    shapes = {"p0": (8, 4), "p1": (8, 2)}  # [T, slots] of each policy's batch
    for i, (pid, (steps, n)) in enumerate(shapes.items()):
        batch = {
            "obs": rng.standard_normal((steps, n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (steps, n)).astype(np.int32),
            "logp": np.full((steps, n), np.log(0.5), np.float32),
            "values": rng.standard_normal((steps, n)).astype(np.float32),
            "rewards": np.ones((steps, n), np.float32),
            "dones": (rng.uniform(size=(steps, n)) < 0.1).astype(np.float32),
            "last_obs": rng.standard_normal((n, 4)).astype(np.float32),
        }
        ref = ref_mod.DiscretePolicyModule(4, 2, (16,))
        params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(i)))
        ref_opt = ref_make_optimizer(ref_cfg)
        key = jax.random.PRNGKey(10 + i)
        (ref_p, _), ref_m = jax.jit(ref_ppo.make_ppo_update(ref, ref_opt, ref_cfg))(
            (params, ref_opt.init(params)), jax.tree.map(jnp.asarray, batch), key)
        N = steps * n
        mb = min(cfg.minibatch_size, N)
        perms = np.stack([np.asarray(jax.random.permutation(k, N)[: (N // mb) * mb]).reshape(N // mb, mb)
                          for k in jax.random.split(key, cfg.num_epochs)])
        mod = DiscretePolicyModule(4, 2, (16,))
        opt = make_optimizer(cfg)
        tparams = params_from_numpy(params, "cpu")
        (p, _), m = ppo.make_ppo_update(mod, opt, cfg).with_perms(
            (tparams, opt.init(tparams)), {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.from_numpy(perms))
        for g, w in zip(tree_leaves(p), jax.tree.leaves(ref_p)):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= UPDATE_TOL * (1 + np.abs(w).max()), pid
        for k in ref_m:
            assert abs(float(m[k]) - float(ref_m[k])) <= UPDATE_TOL * (1 + abs(float(ref_m[k]))), (pid, k)


def test_validation_follows_the_reference():
    for c in (MultiAgentPPOConfig(), RefMultiAgentPPOConfig()):
        with pytest.raises(ValueError, match="ma_env_maker"):
            c.validate()
        c.environment(ma_env_maker=_ma_cartpole(2))
        with pytest.raises(ValueError, match="policies"):
            c.validate()
