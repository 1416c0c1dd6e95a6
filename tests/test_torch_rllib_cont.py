"""The port's continuous-control algorithms (`ray_tpu_torch/rllib/
algorithms/`: SAC, TD3, DDPG) against the JAX reference's
(`ray_tpu/rllib/algorithms/`): the reference's params, carried across by
`params_from_numpy`, give the same module outputs (`actor_dist`,
`sample_action` given its normal draw, `log_prob`, `entropy`, `q_value`,
the deterministic actor), and the same loss terms, gradients and state
after an update of 8 gradient steps given the reference's minibatches and
its draws (JAX's normals fed through `update.with_draws`). TD3's policy
delay and DDPG's single critic without smoothing; a non-Box action space
refused; two iterations of each algorithm.

Tolerances: TOL (1e-6, of each leaf's largest entry) for module outputs
and loss terms, GRAD_TOL (1e-5) for gradients, UPDATE_TOL (1e-5) for the
state and metrics after an update."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import sac as ref_sac
from ray_tpu.rllib.algorithms import td3 as ref_td3
from ray_tpu.rllib.algorithms.ddpg import DDPGConfig as RefDDPGConfig
from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer
from ray_tpu_torch.rllib import DDPGConfig, SACConfig, TD3Config
from ray_tpu_torch.rllib.algorithms import sac, td3
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.utils import optim
from ray_tpu_torch.rllib.utils.tree import tree_leaves
from torch_rl import close, grads_in_state_jax, grads_in_state_port, metrics_close, to_jax, to_torch

TOL = 1e-6
GRAD_TOL = 1e-5
UPDATE_TOL = 1e-5
OBS, ACT, SCALE, HIDDEN = 4, 2, 2.0, (16, 8)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _transitions(k, mb, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((k, mb, OBS)).astype(np.float32),
        "next_obs": rng.standard_normal((k, mb, OBS)).astype(np.float32),
        "actions": rng.uniform(-SCALE, SCALE, (k, mb, ACT)).astype(np.float32),
        "rewards": rng.uniform(-2, 1, (k, mb)).astype(np.float32),
        "dones": (rng.uniform(size=(k, mb)) < 0.2).astype(np.float32),
    }


def _params(ref, seed=0):
    params = _np(ref.init(jax.random.PRNGKey(seed)))
    # Scale the actor's head up from its 0.01 init so actions spread over
    # (-1, 1) and log_std leaves 0; move the targets off the online nets.
    params["actor"][-1]["w"] *= 60.0
    rng = np.random.default_rng(seed + 1)
    for key in [k for k in params if k.endswith("_t")]:
        params[key] = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                                   params[key])
    return params


def _td3_draws(rng, k, mb):
    """The target-policy noise the reference draws: `normal(key_i, actions.shape)`
    for `keys = split(rng, k)` (`td3.py:110-112,185`), stacked [k, mb, act_dim]."""
    return np.stack([np.array(jax.random.normal(key, (mb, ACT))) for key in jax.random.split(rng, k)])


def _sac_draws(rng, k, mb):
    """The reference's two normals of each step: `k_next, k_actor =
    split(key_i)` for `keys = split(rng, k)` (`sac.py:161,207`)."""
    pairs = [jax.random.split(key) for key in jax.random.split(rng, k)]
    return {name: np.stack([np.array(jax.random.normal(p[i], (mb, ACT))) for p in pairs])
            for i, name in enumerate(("next", "actor"))}


# ------------------------------------------------------------------ modules
def test_sac_module_matches_the_references():
    ref = ref_sac.SACModule(OBS, ACT, SCALE, HIDDEN)
    mod = sac.SACModule(OBS, ACT, SCALE, HIDDEN)
    params = _params(ref)
    tparams = rl_module.params_from_numpy(params, "cpu")
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((9, OBS)).astype(np.float32)
    actions = rng.uniform(-SCALE, SCALE, (9, ACT)).astype(np.float32)
    actions[0] = SCALE  # the clip at the bound
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (9, ACT)))
    ref_dist = ref.actor_dist(params["actor"], jnp.asarray(obs))
    dist = mod.actor_dist(tparams["actor"], torch.from_numpy(obs))
    close(dist, ref_dist, TOL, "actor_dist")
    assert float(dist[1].max()) <= 2.0 and float(dist[1].min()) >= -5.0
    close(mod.sample_action(torch.from_numpy(eps), tparams["actor"], torch.from_numpy(obs)),
          ref.sample_action(key, params["actor"], jnp.asarray(obs)), TOL, "sample_action given its draw")
    close(mod.log_prob(dist, torch.from_numpy(actions)), ref.log_prob(ref_dist, jnp.asarray(actions)), TOL,
          "log_prob")
    close(mod.entropy(dist), ref.entropy(ref_dist), TOL, "entropy")
    close(mod.greedy(dist), ref.greedy(ref_dist), TOL, "greedy")
    close(mod.q_value(tparams["q2"], torch.from_numpy(obs), torch.from_numpy(actions)),
          ref.q_value(params["q2"], jnp.asarray(obs), jnp.asarray(actions)), TOL, "q_value")
    (_, v), (_, ref_v) = mod.forward(tparams, torch.from_numpy(obs)), ref.forward(params, jnp.asarray(obs))
    close(v, ref_v, 0.0, "value")
    # The init's tree: the reference's leaves and shapes, targets equal to the critics.
    own = mod.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [a.shape for a in jax.tree.leaves(
        _np(ref.init(jax.random.PRNGKey(0))))]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own["q1"]), tree_leaves(own["q1_t"])))
    assert float(own["log_alpha"]) == pytest.approx(np.log(0.2))
    # sample() draws squashed actions inside the bound.
    a = mod.sample(torch.Generator().manual_seed(0), dist)
    assert a.shape == (9, ACT) and float(a.abs().max()) <= SCALE


def test_td3_module_matches_the_references():
    ref = ref_td3.TD3Module(OBS, ACT, SCALE, HIDDEN, exploration_noise=0.3)
    mod = td3.TD3Module(OBS, ACT, SCALE, HIDDEN, exploration_noise=0.3)
    params = _params(ref)
    tparams = rl_module.params_from_numpy(params, "cpu")
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((9, OBS)).astype(np.float32)
    unit = rng.uniform(-1, 1, (9, ACT)).astype(np.float32)
    (dist, v), (ref_dist, ref_v) = mod.forward(tparams, torch.from_numpy(obs)), ref.forward(params, jnp.asarray(obs))
    close([dist, v], [ref_dist, ref_v], TOL, "forward")
    close(mod.act(tparams["actor_t"], torch.from_numpy(obs)), ref.act(params["actor_t"], jnp.asarray(obs)), TOL,
          "act")
    close(mod.q_value(tparams["q1"], torch.from_numpy(obs), torch.from_numpy(unit)),
          ref.q_value(params["q1"], jnp.asarray(obs), jnp.asarray(unit)), TOL, "q_value")
    close(mod.greedy(dist), ref.greedy(ref_dist), TOL, "greedy")
    close([mod.log_prob(dist, dist), mod.entropy(dist)], [ref.log_prob(ref_dist, ref_dist), ref.entropy(ref_dist)],
          0.0, "zeros")
    own = mod.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [a.shape for a in jax.tree.leaves(
        _np(ref.init(jax.random.PRNGKey(0))))]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own["actor"]), tree_leaves(own["actor_t"])))
    # Exploration: clip(mean + 0.3·N(0, 1), -1, 1)·scale, its noise from the generator.
    a = mod.sample(torch.Generator().manual_seed(0), dist)
    noise = 0.3 * torch.randn(dist.shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, torch.clamp(dist + noise, -1, 1) * SCALE, rtol=0, atol=0)


# ------------------------------------------------------------------ updates
def _sac_pair(what, tau=0.005):
    cfg = ref_sac.SACConfig()
    cfg.tau = tau
    ref = ref_sac.SACModule(OBS, ACT, SCALE, HIDDEN)
    mod = sac.SACModule(OBS, ACT, SCALE, HIDDEN)
    if what == "grads":
        ref_opts = [grads_in_state_jax() for _ in range(3)]
        opts = [grads_in_state_port() for _ in range(3)]
    else:
        ref_opts = [ref_make_optimizer(cfg) for _ in range(3)]
        opts = [optim.make_optimizer(cfg) for _ in range(3)]
    return (ref, ref_sac.make_sac_update(ref, *ref_opts, cfg, -float(ACT)), ref_opts,
            mod, sac.make_sac_update(mod, *opts, cfg, -float(ACT)), opts)


def _sac_states(params, tparams, ref_opts, opts):
    def split(p):
        return p["actor"], {"q1": p["q1"], "q2": p["q2"]}, p["log_alpha"]

    return ((params, tuple(o.init(x) for o, x in zip(ref_opts, split(params)))),
            (tparams, tuple(o.init(x) for o, x in zip(opts, split(tparams)))))


@pytest.mark.parametrize("what", ["grads", "update"])
def test_sac_update_matches_the_references_given_its_draws(what):
    """`grads`: one step, optimizers that hand back the gradients of the
    critics, the actor and log_alpha; `update`: 8 steps with three Adams."""
    k = 1 if what == "grads" else 8
    ref, ref_update, ref_opts, mod, update, opts = _sac_pair(what, tau=0.05)
    params = _params(ref)
    tparams = rl_module.params_from_numpy(params, "cpu")
    mbs = _transitions(k, 32, seed=5)
    rng = jax.random.PRNGKey(11)
    ref_state, state = _sac_states(params, tparams, ref_opts, opts)
    (ref_p, ref_s), ref_m = jax.jit(ref_update)(ref_state, to_jax(mbs), rng)
    draws = {n: torch.from_numpy(d) for n, d in _sac_draws(rng, k, 32).items()}
    (p, s), m = update.with_draws(state, to_torch(mbs), draws)
    if what == "grads":
        metrics_close(m, ref_m, TOL, "loss terms")
        close(s, ref_s, GRAD_TOL, "grads")
        close(p, ref_p, TOL, "params (online unchanged, targets moved)")
    else:
        metrics_close(m, ref_m, UPDATE_TOL)
        close(p, ref_p, UPDATE_TOL, "params")
        close(s, ref_s, UPDATE_TOL, "optimizer states")
        assert [int(x[0].count) for x in s] == [int(x[0][0].count) for x in ref_s] == [k] * 3
    # update(state, batches, gen) is with_draws given the generator's two [k, mb, act_dim] normals.
    gen = torch.Generator().manual_seed(3)
    (p1, _), m1 = update(state, to_torch(mbs), gen)
    again = torch.Generator().manual_seed(3)
    shape = mbs["actions"].shape
    mine = {n: torch.randn(shape, generator=again) for n in ("next", "actor")}
    (p2, _), m2 = update.with_draws(state, to_torch(mbs), mine)
    close(p1, _np_tree(p2), 0.0, "update = with_draws")
    metrics_close(m1, {kk: float(v) for kk, v in m2.items()}, 0.0)


def _np_tree(tree):
    return [t.numpy() for t in tree_leaves(tree)]


def _td3_pair(ref_cfg, port_cfg, what):
    ref = ref_td3.TD3Module(OBS, ACT, SCALE, HIDDEN)
    mod = td3.TD3Module(OBS, ACT, SCALE, HIDDEN)
    if what == "grads":
        ref_opts, opts = [grads_in_state_jax(), grads_in_state_jax()], [grads_in_state_port(), grads_in_state_port()]
    else:
        ref_opts = [ref_make_optimizer(ref_cfg), ref_make_optimizer(ref_cfg)]
        opts = [optim.make_optimizer(port_cfg), optim.make_optimizer(port_cfg)]
    return (ref, ref_td3.make_td3_update(ref, *ref_opts, ref_cfg), ref_opts,
            mod, td3.make_td3_update(mod, *opts, port_cfg), opts)


def _td3_run(ref_cfg, port_cfg, what, k, seed=6):
    ref, ref_update, ref_opts, mod, update, opts = _td3_pair(ref_cfg, port_cfg, what)
    params = _params(ref)
    tparams = rl_module.params_from_numpy(params, "cpu")
    keys = ("q1", "q2") if ref_cfg.use_twin_q else ("q1",)
    ref_state = (params, (ref_opts[0].init(params["actor"]), ref_opts[1].init({c: params[c] for c in keys})))
    state = (tparams, (opts[0].init(tparams["actor"]), opts[1].init({c: tparams[c] for c in keys})))
    mbs = _transitions(k, 32, seed=seed)
    rng = jax.random.PRNGKey(13)
    (ref_p, ref_s), ref_m = jax.jit(ref_update)(ref_state, to_jax(mbs), rng)
    (p, s), m = update.with_draws(state, to_torch(mbs), torch.from_numpy(_td3_draws(rng, k, 32)))
    return (p, s, m), (ref_p, ref_s, ref_m), update, state, mbs


def _cfgs(kind, **kw):
    ref_cfg, port_cfg = (ref_td3.TD3Config(), TD3Config()) if kind == "td3" else (RefDDPGConfig(), DDPGConfig())
    for c in (ref_cfg, port_cfg):
        c.tau = 0.05
        for name, value in kw.items():
            setattr(c, name, value)
    return ref_cfg, port_cfg


@pytest.mark.parametrize("kind,what", [("td3", "grads"), ("td3", "update"), ("ddpg", "grads"), ("ddpg", "update")])
def test_td3_and_ddpg_updates_match_the_references_given_its_draws(kind, what):
    k = 1 if what == "grads" else 8
    (p, s, m), (ref_p, ref_s, ref_m), _, _, _ = _td3_run(*_cfgs(kind), what, k)
    if what == "grads":
        metrics_close(m, ref_m, TOL, "loss terms")
        close(s, ref_s, GRAD_TOL, "grads (actor, critics)")
        close(p, ref_p, TOL, "params (online unchanged, targets moved)")
    else:
        metrics_close(m, ref_m, UPDATE_TOL)
        close(p, ref_p, UPDATE_TOL, "params")
        close(s, ref_s, UPDATE_TOL, "optimizer states")


@pytest.mark.parametrize("delay,k", [(2, 8), (3, 8), (1, 5)])
def test_td3_policy_delay_cadence(delay, k):
    """The actor and every target move on steps 0, delay, 2·delay, ... of
    each update, the critics on every step; a step without the actor adds
    0 to the mean actor loss."""
    (p, s, m), (ref_p, ref_s, ref_m), update, state, mbs = _td3_run(*_cfgs("td3", policy_delay=delay), "update", k)
    actor_steps = len(range(0, k, delay))
    assert int(s[0][0].count) == int(ref_s[0][0][0].count) == actor_steps
    assert int(s[1][0].count) == int(ref_s[1][0][0].count) == k
    _, variants = update.scan_inputs(to_torch(mbs), torch.zeros(k, 32, ACT))
    assert variants == [i % delay == 0 for i in range(k)]
    close(p, ref_p, UPDATE_TOL, "params")
    # The actor loss is averaged over all k steps: the skipped ones count 0.
    steps = []
    st = state
    inputs, variants = update.scan_inputs(to_torch(mbs), torch.from_numpy(_td3_draws(jax.random.PRNGKey(13), k, 32)))
    for i, v in enumerate(variants):
        st, aux = update.step(st, {"mb": {kk: x[i] for kk, x in inputs["mb"].items()}, "noise": inputs["noise"][i]}, v)
        steps.append(float(aux["actor_loss"]))
    assert [x == 0.0 for x in steps] == [not v for v in variants]
    assert float(m["actor_loss"]) == pytest.approx(sum(steps) / k, rel=1e-6)


def test_ddpg_has_one_critic_and_no_smoothing():
    """DDPG: the critic optimizer holds q1 alone, q2 and q2_t never move,
    and the target-policy draws change nothing (target_noise = noise_clip = 0)."""
    ref_cfg, port_cfg = _cfgs("ddpg")
    assert (port_cfg.use_twin_q, port_cfg.target_noise, port_cfg.noise_clip, port_cfg.policy_delay) == \
        (False, 0.0, 0.0, 1)
    (p, s, _), _, update, state, mbs = _td3_run(ref_cfg, port_cfg, "update", 4)
    assert set(s[1][0].mu) == {"q1"}
    for key in ("q2", "q2_t"):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p[key]), tree_leaves(state[0][key])))
    (p_other, _), _ = update.with_draws(state, to_torch(mbs), 5.0 * torch.ones(4, 32, ACT))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(p_other)))


def test_step_program_on_the_cpu_is_the_eager_scan():
    """On the CPU the update is `optim.scan_steps` of its step, eagerly."""
    _, _, _, mod, update, opts = _sac_pair("update")
    tparams = mod.init(torch.Generator().manual_seed(2))
    state = (tparams, (opts[0].init(tparams["actor"]), opts[1].init({"q1": tparams["q1"], "q2": tparams["q2"]}),
                       opts[2].init(tparams["log_alpha"])))
    mbs = to_torch(_transitions(3, 16, seed=8))
    gen = torch.Generator().manual_seed(4)
    draws = {n: torch.randn(mbs["actions"].shape, generator=gen) for n in ("next", "actor")}
    (p1, s1), m1 = update.with_draws(state, mbs, draws)
    (p2, s2), m2 = optim.scan_steps(update.step, state, *update.scan_inputs(mbs, draws))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p1, s1, m1)), tree_leaves((p2, s2, m2))))


# ------------------------------------------------------------------ algorithms
def _pendulum(config, **training):
    return (config.environment("Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4, rollout_fragment_length=16)
            .training(train_batch_size=64, learning_starts=64, num_grad_steps=4, minibatch_size=16,
                      model={"hidden": (16, 16)}, **training)
            .debugging(seed=0).resources(device="cpu").build())


@pytest.mark.parametrize("name", ["sac", "td3", "ddpg"])
def test_two_iterations_of_each_algorithm(name):
    algo = _pendulum({"sac": SACConfig, "td3": TD3Config, "ddpg": DDPGConfig}[name]())
    try:
        results = [algo.train() for _ in range(2)]
    finally:
        algo.stop()
    assert [r["num_env_steps_sampled_this_iter"] for r in results] == [64, 64]
    assert len(algo._buffer) == 128 and algo._buffer.actions.shape[1:] == (1,)
    assert algo._buffer.actions.dtype == np.float32
    learner = results[-1]["info"]["learner"]
    assert set(learner) == ({"critic_loss", "actor_loss", "alpha", "q_mean", "entropy"} if name == "sac"
                            else {"critic_loss", "actor_loss", "q_mean"})
    assert all(np.isfinite(v) for v in learner.values())
    # The sampled actions lie inside Pendulum's torque bound.
    assert float(np.abs(algo._buffer.actions[:128]).max()) <= 2.0


@pytest.mark.parametrize("config", [SACConfig, TD3Config, DDPGConfig])
def test_a_discrete_action_space_is_refused(config):
    with pytest.raises(TypeError, match="continuous"):
        config().environment("CartPole-v1").resources(device="cpu").build()
