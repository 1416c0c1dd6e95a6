"""The port's on-policy and Q-learning algorithms (`ray_tpu_torch/rllib/
algorithms/`: A2C, IMPALA, APPO, DQN, Ape-X DQN) against the JAX
reference's (`ray_tpu/rllib/algorithms/`): the same numpy batches and the
reference's params, carried across by `params_from_numpy`, give the same
loss terms and gradients, and the same state after one update (DQN given
the same [k, mb] minibatches); IMPALA and APPO with a categorical and a
Gaussian head, IMPALA with adam and rmsprop; Ape-X's TD errors and a
shard's priorities. Then the port alone: epsilon-greedy sampling against
eps, 3 iterations of each algorithm with exact step counts, and
IMPALA's async path and Ape-X's replay shards in one small cluster.

Tolerances: TOL (1e-6, of each leaf's largest entry) for loss terms and
TD errors, GRAD_TOL (1e-5) for gradients, UPDATE_TOL (1e-5) for the state
after an update."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms import a2c as ref_a2c
from ray_tpu.rllib.algorithms import apex_dqn as ref_apex
from ray_tpu.rllib.algorithms import appo as ref_appo
from ray_tpu.rllib.algorithms import dqn as ref_dqn
from ray_tpu.rllib.algorithms import impala as ref_impala
from ray_tpu.rllib.core import rl_module as ref_mod
from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer
from ray_tpu_torch.rllib import A2CConfig, APPOConfig, ApexDQNConfig, DQNConfig, IMPALAConfig
from ray_tpu_torch.rllib.algorithms import a2c, apex_dqn, appo, dqn, impala
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.utils import optim
from ray_tpu_torch.rllib.utils.tree import tree_leaves
from torch_rl import (close, grads_in_state_jax, grads_in_state_port, metrics_close, to_jax,
                      to_torch)

TOL = 1e-6
GRAD_TOL = 1e-5
UPDATE_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _modules(kind):
    if kind == "gaussian":
        return ref_mod.GaussianPolicyModule(4, 2, (16,)), rl_module.GaussianPolicyModule(4, 2, (16,))
    return ref_mod.DiscretePolicyModule(4, 3, (16, 8)), rl_module.DiscretePolicyModule(4, 3, (16, 8))


def _rollout(ref, params, kind, T=16, B=8, seed=0):
    """A time-major batch as an EnvRunner returns it, its behaviour logp
    the module's own, off by a little noise (so V-trace's rhos fall on both
    sides of their clips)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, 4)).astype(np.float32)
    if kind == "gaussian":
        actions = rng.standard_normal((T, B, 2)).astype(np.float32)
    else:
        actions = rng.integers(0, 3, (T, B)).astype(np.int32)
    dist, values = ref.forward(params, jnp.asarray(obs))
    logp = np.asarray(ref.log_prob(dist, jnp.asarray(actions)))
    return {
        "obs": obs,
        "actions": actions,
        "logp": (logp + 0.3 * rng.standard_normal((T, B))).astype(np.float32),
        "values": np.asarray(values),
        "rewards": rng.uniform(0, 1, (T, B)).astype(np.float32),
        "dones": (rng.uniform(size=(T, B)) < 0.1).astype(np.float32),
        "last_obs": rng.standard_normal((B, 4)).astype(np.float32),
    }


def _params(ref, kind, seed=0):
    params = _np(ref.init(jax.random.PRNGKey(seed)))
    if kind == "gaussian":
        params["log_std"] = np.array([-0.2, 0.3], np.float32)
    # Scale the heads up from their 0.01 init so the policy is not uniform.
    params["pi"][-1]["w"] *= 50.0
    return params


def _one_step(ref_make, port_make, cfg, kind, what, opt_kind="adam"):
    """The reference's jitted update and the port's, from the same params
    and batch. `what` "grads": optimizers that hand back the gradient;
    "update": the configured optimizer chain."""
    ref, mod = _modules(kind)
    params = _params(ref, kind)
    batch = _rollout(ref, params, kind)
    if what == "grads":
        ref_opt, opt = grads_in_state_jax(), grads_in_state_port()
    else:
        ref_opt, opt = ref_make_optimizer(cfg, opt_kind), optim.make_optimizer(cfg, opt_kind)
    (ref_p, ref_s), ref_m = jax.jit(ref_make(ref, ref_opt, cfg))(
        (params, ref_opt.init(params)), to_jax(batch), jax.random.PRNGKey(0))
    tparams = rl_module.params_from_numpy(params, "cpu")
    (p, s), m = port_make(mod, opt, cfg)((tparams, opt.init(tparams)), to_torch(batch), torch.Generator())
    metrics_close(m, ref_m, TOL if what == "grads" else UPDATE_TOL, "loss terms")
    if what == "grads":
        close(s, ref_s, GRAD_TOL, "grads")
        close(p, params, 0.0, "params unchanged")
    else:
        close(p, ref_p, UPDATE_TOL, "params")
        close(s, ref_s, UPDATE_TOL, "optimizer state")
    return m


# ------------------------------------------------------------------ A2C
@pytest.mark.parametrize("what", ["grads", "update"])
def test_a2c_matches_the_references(what):
    cfg = ref_a2c.A2CConfig()
    cfg.lambda_ = 0.95
    _one_step(ref_a2c.make_a2c_update, a2c.make_a2c_update, cfg, "discrete", what)


# --------------------------------------------------------------- IMPALA
@pytest.mark.parametrize("kind,opt_kind,what", [
    ("discrete", "adam", "grads"), ("gaussian", "adam", "grads"),
    ("discrete", "adam", "update"), ("discrete", "rmsprop", "update"),
    ("gaussian", "adam", "update"), ("gaussian", "rmsprop", "update"),
])
def test_impala_vtrace_update_matches_the_references(kind, opt_kind, what):
    cfg = ref_impala.IMPALAConfig()
    cfg.opt = opt_kind
    m = _one_step(ref_impala.make_vtrace_update, impala.make_vtrace_update, cfg, kind, what, opt_kind)
    assert 0.3 < float(m["mean_rho"]) < 3.0  # off-policy enough for both clips to bite


def test_vtrace_equals_the_closed_form_when_on_policy():
    """rho = c = 1, no dones: vs_t = sum_k γ^(k-t) r_k + γ^(T-t) V(last)."""
    T, B, g = 5, 3, 0.9
    gen = torch.Generator().manual_seed(0)
    batch = {"rewards": torch.rand(T, B, generator=gen), "dones": torch.zeros(T, B)}
    values, last = torch.rand(T, B, generator=gen), torch.rand(B, generator=gen)
    ones = torch.ones(T, B)
    vs, _ = impala.vtrace(batch, values, last, ones, ones, g)
    want = torch.stack([sum(g ** (k - t) * batch["rewards"][k] for k in range(t, T)) + g ** (T - t) * last
                        for t in range(T)])
    torch.testing.assert_close(vs, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- APPO
@pytest.mark.parametrize("kind,what", [("discrete", "grads"), ("gaussian", "grads"),
                                       ("discrete", "update"), ("gaussian", "update")])
def test_appo_update_matches_the_references(kind, what):
    cfg = ref_appo.APPOConfig()
    m = _one_step(ref_appo.make_appo_update, appo.make_appo_update, cfg, kind, what)
    assert 0.0 < float(m["clip_frac"]) < 1.0


# ------------------------------------------------------------------ DQN
def _q_modules(obs_dim=4, n_actions=3, hidden=(16, 8)):
    return (ref_dqn.QPolicyModule(obs_dim, n_actions, hidden),
            dqn.QPolicyModule(obs_dim, n_actions, hidden))


def _q_params(ref, seed=0):
    params = _np(ref.init(jax.random.PRNGKey(seed)))
    # A target apart from the online net (the Polyak average has moved it).
    rng = np.random.default_rng(seed + 1)
    params["target"] = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                                    params["target"])
    params["eps"] = np.asarray(0.25, np.float32)
    return params


def _transitions(k, mb, obs_dim=4, n_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((k, mb, obs_dim)).astype(np.float32),
        "next_obs": rng.standard_normal((k, mb, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, n_actions, (k, mb)).astype(np.int32),
        "rewards": rng.uniform(-1, 2, (k, mb)).astype(np.float32),
        "dones": (rng.uniform(size=(k, mb)) < 0.2).astype(np.float32),
    }


def test_q_policy_module_matches_the_references():
    ref, mod = _q_modules()
    params = _q_params(ref)
    obs = np.random.default_rng(3).standard_normal((9, 4)).astype(np.float32)
    (ref_q, ref_eps), ref_v = ref.forward(params, jnp.asarray(obs))
    (q, eps), v = mod.forward(rl_module.params_from_numpy(params, "cpu"), torch.from_numpy(obs))
    close([q, eps, v], [ref_q, ref_eps, ref_v], TOL, "forward")
    close(mod.greedy((q, eps)), ref.greedy((ref_q, ref_eps)), 0.0, "greedy")
    assert eps.shape == () and float(eps) == 0.25
    # The init's tree: online and target equal, eps a 0-d leaf at 1.
    own = mod.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [a.shape for a in jax.tree.leaves(_np(ref.init(
        jax.random.PRNGKey(0))))]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own["online"]), tree_leaves(own["target"])))
    assert float(own["eps"]) == 1.0


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
def test_epsilon_greedy_sampling_follows_eps(eps):
    """P(a) = (1 - ε)·[a = greedy] + ε/n: a χ² test over 30,000 draws."""
    n, draws = 3, 30000
    q = torch.tensor([[0.1, 2.0, -1.0]]).expand(draws, n)
    acts = dqn.QPolicyModule.sample(torch.Generator().manual_seed(0), (q, torch.tensor(eps)))
    assert acts.dtype == torch.int32
    counts = np.bincount(acts.numpy(), minlength=n)
    expect = np.full(n, draws * eps / n)
    expect[1] += draws * (1 - eps)
    if eps == 0.0:
        assert counts.tolist() == [0, draws, 0]
        return
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 13.82, (counts, expect)  # χ² with 2 degrees of freedom, p = 0.001
    again = dqn.QPolicyModule.sample(torch.Generator().manual_seed(0), (q, torch.tensor(eps)))
    assert torch.equal(acts, again)


def test_epsilon_schedule_is_the_references():
    cfg = DQNConfig()
    cfg.epsilon_decay_steps = 1000
    for t in (0, 1, 250, 999, 1000, 5000):
        this = types.SimpleNamespace(config=cfg, _timesteps_total=t)
        assert dqn.DQN._epsilon(this) == ref_dqn.DQN._epsilon(this)
    assert dqn.DQN._epsilon(types.SimpleNamespace(config=cfg, _timesteps_total=500)) == pytest.approx(0.525)


def test_huber_loss_is_optax():
    import optax

    x = np.linspace(-3, 3, 61).astype(np.float32)
    close(dqn.huber_loss(torch.from_numpy(x)), optax.huber_loss(jnp.asarray(x)), 1e-7, "huber")


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_loss_and_gradients_match_the_references(double_q):
    """One minibatch: the loss terms, the gradient w.r.t. the online net,
    and the target moved by Polyak toward the (unchanged) online net."""
    cfg = ref_dqn.DQNConfig()
    cfg.double_q = double_q
    ref, mod = _q_modules()
    params = _q_params(ref)
    mbs = _transitions(1, 32)
    ref_opt, opt = grads_in_state_jax(), grads_in_state_port()
    (ref_p, ref_s), ref_m = jax.jit(ref_dqn.make_dqn_update(ref, ref_opt, cfg))(
        (params, ref_opt.init(params["online"])), to_jax(mbs), jax.random.PRNGKey(0))
    tparams = rl_module.params_from_numpy(params, "cpu")
    (p, s), m = dqn.make_dqn_update(mod, opt, cfg)((tparams, opt.init(tparams["online"])), to_torch(mbs), None)
    metrics_close(m, ref_m, TOL, "loss terms")
    close(s, ref_s, GRAD_TOL, "grads")
    close(p, ref_p, TOL, "params (online unchanged, target moved)")


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_the_references_given_its_minibatches(double_q):
    cfg = ref_dqn.DQNConfig()
    cfg.double_q = double_q
    cfg.target_network_update_tau = 0.1
    ref, mod = _q_modules()
    params = _q_params(ref)
    mbs = _transitions(6, 32, seed=4)
    ref_opt, opt = ref_make_optimizer(cfg), optim.make_optimizer(cfg)
    (ref_p, ref_s), ref_m = jax.jit(ref_dqn.make_dqn_update(ref, ref_opt, cfg))(
        (params, ref_opt.init(params["online"])), to_jax(mbs), jax.random.PRNGKey(0))
    tparams = rl_module.params_from_numpy(params, "cpu")
    (p, s), m = dqn.make_dqn_update(mod, opt, cfg)((tparams, opt.init(tparams["online"])), to_torch(mbs), None)
    metrics_close(m, ref_m, UPDATE_TOL)
    close(p, ref_p, UPDATE_TOL, "params")
    close(s, ref_s, UPDATE_TOL, "optimizer state")
    assert int(s[1].count) == int(ref_s[1][0].count) == 6


# ---------------------------------------------------------------- Ape-X
def _apex_self(module, params):
    """What `_td_errors` reads of the algorithm: the learner's weights, the
    module, gamma and the device."""
    group = types.SimpleNamespace(get_weights=lambda: params)
    return types.SimpleNamespace(learner_group=group, module=module,
                                 config=types.SimpleNamespace(gamma=0.97, device="cpu"))


def test_apex_td_errors_and_priorities_match_the_references():
    ref, mod = _q_modules()
    params = _q_params(ref)
    mbs = _transitions(2, 16, seed=5)
    want = ref_apex.ApexDQN._td_errors(_apex_self(ref, params), mbs)
    got = apex_dqn.ApexDQN._td_errors(_apex_self(mod, params), mbs)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (32,)
    close(got, want, TOL, "td errors")

    # A shard's priorities after update_priorities, and what it samples then.
    frag = {"obs": mbs["obs"], "last_obs": mbs["next_obs"][-1], "actions": mbs["actions"],
            "rewards": mbs["rewards"], "dones": mbs["dones"]}
    shard, ref_shard = apex_dqn.ReplayShard(64, 4, 0.6, 0.4, seed=3), ref_apex.ReplayShard(64, 4, 0.6, 0.4, seed=3)
    assert shard.add_fragment(frag) == ref_shard.add_fragment(frag) == 32
    idx = np.arange(32)
    shard.update_priorities(idx, got)
    ref_shard.update_priorities(idx, want)
    close(shard._buf.priorities, ref_shard._buf.priorities, TOL, "priorities")
    assert not np.all(shard._buf.priorities[:32] == 1.0)
    same = apex_dqn.ReplayShard(64, 4, 0.6, 0.4, seed=3)
    same.add_fragment(frag)
    same.update_priorities(idx, want)
    np.testing.assert_array_equal(same._buf.priorities, ref_shard._buf.priorities)
    (out, ind), (ref_out, ref_ind) = same.sample(2, 8), ref_shard.sample(2, 8)
    np.testing.assert_array_equal(ind, ref_ind)
    for k in ref_out:
        np.testing.assert_array_equal(out[k], ref_out[k])


# --------------------------------------------------------- training loops
def _local(config, **training):
    return (config.environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=16)
            .training(**training).debugging(seed=0).resources(device="cpu").build())


@pytest.mark.parametrize("name", ["a2c", "impala", "appo", "dqn"])
def test_three_iterations_of_each_local_algorithm(name):
    algo = {
        "a2c": lambda: _local(A2CConfig()),
        "impala": lambda: _local(IMPALAConfig()),
        "appo": lambda: _local(APPOConfig()),
        "dqn": lambda: _local(DQNConfig(), learning_starts=64, num_grad_steps=4, minibatch_size=16),
    }[name]()
    try:
        results = [algo.train() for _ in range(3)]
    finally:
        algo.stop()
    assert [r["num_env_steps_sampled_this_iter"] for r in results] == [64] * 3
    assert results[-1]["timesteps_total"] == 192
    loss = "td_loss" if name == "dqn" else "total_loss"
    assert all(np.isfinite(r["info"]["learner"][loss]) for r in results)
    if name == "dqn":
        assert algo._buffer.size == 192
        assert algo._weights["eps"] < 1.0 and algo._weights["eps"].dtype == np.float32


class _CountingStore:
    """The runtime module as an algorithm uses it, its `put`s counted."""

    def __init__(self, ray):
        self._ray, self.puts = ray, 0

    def put(self, value):
        self.puts += 1
        return self._ray.put(value)

    def __getattr__(self, name):
        return getattr(self._ray, name)


@pytest.mark.cluster
def test_impala_async_and_apex_shards_in_a_cluster():
    """IMPALA's async path (2 CPU-actor runners) and Ape-X (2 runners, 2
    replay shards) on one small cluster: every consumed fragment's steps
    counted, each consumed runner re-armed, the weights re-put once per
    broadcast_interval updates; the shards hold every pushed step and every
    update writes one priority per sampled transition."""
    rt.init(num_cpus=4)
    try:
        algo = (IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=16)
                .training(broadcast_interval=2).debugging(seed=0).resources(device="cpu").build())
        try:
            store = algo._ray = _CountingStore(algo._ray)
            update, updates = algo.learner_group.update, []
            algo.learner_group.update = lambda b: updates.append(b["rewards"].shape) or update(b)
            results = [algo.train() for _ in range(3)]
            steps = [r["num_env_steps_sampled_this_iter"] for r in results]
            assert all(n > 0 and n % 64 == 0 for n in steps)
            assert sum(steps) == 64 * len(updates) == results[-1]["timesteps_total"]
            assert all(shape == (16, 4) for shape in updates)
            assert sorted(map(id, algo._inflight.values())) == sorted(map(id, algo._remote_runners))
            assert store.puts == 3 + len(updates) // 2
            assert all(np.isfinite(r["info"]["learner"]["mean_rho"]) for r in results)
        finally:
            algo.stop()

        apex = (ApexDQNConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=8)
                .training(learning_starts=64, minibatch_size=16, num_grad_steps=4)
                .debugging(seed=0).resources(device="cpu").build())
        try:
            td, sizes = apex._td_errors, []

            def counted(mbs):
                out = td(mbs)
                sizes.append((mbs["obs"].shape[0] * mbs["obs"].shape[1], out.size))
                return out

            apex._td_errors = counted
            results = [apex.train() for _ in range(3)]
            shard_sizes = rt.get([s.size.remote() for s in apex._shards])
            assert [r["num_env_steps_sampled_this_iter"] for r in results] == [64] * 3
            assert sum(shard_sizes) == 192 and shard_sizes == [96, 96]
            assert sizes and all(n == m == 2 * 16 for n, m in sizes)  # per_shard = 4 // 2 minibatches
            assert np.isfinite(results[-1]["info"]["learner"]["td_loss"])
            out, _ = rt.get(apex._shards[0].sample.remote(1, 64))
            assert out["weights"].min() < 1.0  # the priorities moved off the initial maximum
        finally:
            apex.stop()
    finally:
        rt.shutdown()
