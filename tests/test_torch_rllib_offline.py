"""The port's offline algorithms (`ray_tpu_torch/rllib/algorithms/`: BC,
MARWIL, CQL) against the JAX reference's (`ray_tpu/rllib/algorithms/`):
the same numpy batch and the reference's params, carried across by
`params_from_numpy`, give the same loss terms and gradients, and the same
state after one update given the permutations JAX drew (fed through
`update.with_perms`); MARWIL with its advantage weights clipped on both
sides. The datasets `collect_dataset` makes equal the reference's. Then the
port alone: the validation errors, the transition data CQL reads, and a
3 iterations of each algorithm.

Tolerances: TOL (1e-6, of each leaf's largest entry) for loss terms,
GRAD_TOL (1e-5) for gradients, UPDATE_TOL (1e-5) for the state after an
update of 8 minibatch steps."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import bc as ref_bc
from ray_tpu.rllib.algorithms import cql as ref_cql
from ray_tpu.rllib.algorithms import dqn as ref_dqn
from ray_tpu.rllib.algorithms import marwil as ref_marwil
from ray_tpu.rllib.core import rl_module as ref_mod
from ray_tpu.rllib.offline import collect_dataset as ref_collect_dataset
from ray_tpu.rllib.utils.optim import make_optimizer as ref_make_optimizer
from ray_tpu_torch.rllib import BCConfig, CQLConfig, MARWILConfig
from ray_tpu_torch.rllib.algorithms import bc, cql, dqn, marwil
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.offline import OfflineDataset, collect_dataset
from ray_tpu_torch.rllib.utils import optim
from torch_rl import close, grads_in_state_jax, grads_in_state_port, jax_perms, metrics_close, to_jax, to_torch

TOL = 1e-6
GRAD_TOL = 1e-5
UPDATE_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _expert(obs: np.ndarray) -> np.ndarray:
    """Scripted CartPole expert (the reference test's): push toward the pole's fall."""
    return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)


def _cfg(ref_cls, **kw):
    cfg = ref_cls()
    cfg.train_batch_size, cfg.minibatch_size, cfg.num_epochs = 128, 32, 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _samples(N=128, seed=0, returns_scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((N, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, N).astype(np.int64),
        "returns": (returns_scale * rng.uniform(-1, 1, N)).astype(np.float32),
    }


def _policy_step(ref_make, port_make, cfg, what, batch):
    """The reference's jitted update and the port's given JAX's
    permutations, from the same params and batch."""
    ref, mod = ref_mod.DiscretePolicyModule(4, 3, (16, 8)), rl_module.DiscretePolicyModule(4, 3, (16, 8))
    params = _np(ref.init(jax.random.PRNGKey(0)))
    params["pi"][-1]["w"] *= 50.0  # off the near-uniform 0.01 init
    return _step(ref_make, port_make, cfg, what, batch, ref, mod, params, lambda p: p)


def _step(ref_make, port_make, cfg, what, batch, ref, mod, params, opt_params):
    if what == "grads":
        ref_opt, opt = grads_in_state_jax(), grads_in_state_port()
    else:
        ref_opt, opt = ref_make_optimizer(cfg), optim.make_optimizer(cfg)
    key = jax.random.PRNGKey(7)
    (ref_p, ref_s), ref_m = jax.jit(ref_make(ref, ref_opt, cfg))(
        (params, ref_opt.init(opt_params(params))), to_jax(batch), key)
    perms = jax_perms(key, len(batch["obs"]), cfg.num_epochs, cfg.minibatch_size)
    tparams = rl_module.params_from_numpy(params, "cpu")
    update = port_make(mod, opt, cfg)
    (p, s), m = update.with_perms((tparams, opt.init(opt_params(tparams))), to_torch(batch), torch.from_numpy(perms))
    metrics_close(m, ref_m, TOL if what == "grads" else UPDATE_TOL, "loss terms")
    if what == "grads":
        close(s, ref_s, GRAD_TOL, "grads")
    else:
        close(p, ref_p, UPDATE_TOL, "params")
        close(s, ref_s, UPDATE_TOL, "optimizer state")
        assert int(s[1].count) == int(ref_s[1][0].count) == perms.shape[0] * perms.shape[1]
    return update, tparams, opt


# ----------------------------------------------------------------- BC
@pytest.mark.parametrize("what", ["grads", "update"])
def test_bc_matches_the_references_given_its_permutations(what):
    cfg = _cfg(ref_bc.BCConfig, **({"train_batch_size": 32, "num_epochs": 1} if what == "grads" else {}))
    _policy_step(ref_bc.make_bc_update, bc.make_bc_update, cfg, what, _samples(cfg.train_batch_size))


def test_supervised_update_draws_one_permutation_per_epoch():
    """update(state, batch, gen) is update.with_perms given optim.minibatch_perms from
    the same generator: one permutation of train_batch_size per epoch."""
    cfg = BCConfig()
    cfg.train_batch_size, cfg.minibatch_size, cfg.num_epochs = 64, 16, 3
    mod = rl_module.DiscretePolicyModule(4, 3, (8,))
    params = mod.init(torch.Generator().manual_seed(0))
    opt = optim.make_optimizer(cfg)
    update = bc.make_bc_update(mod, opt, cfg)
    batch = to_torch(_samples(64))
    (p1, _), m1 = update((params, opt.init(params)), batch, torch.Generator().manual_seed(5))
    perms = optim.minibatch_perms(torch.Generator().manual_seed(5), 64, 3, 4, 16)
    (p2, _), m2 = update.with_perms((params, opt.init(params)), batch, perms)
    close(p1, p2, 0.0, "params")
    assert m1 == m2 and all(sorted(e.reshape(-1).tolist()) == list(range(64)) for e in perms)


# ------------------------------------------------------------- MARWIL
@pytest.mark.parametrize("what,beta", [("grads", 1.0), ("update", 1.0), ("update", 0.0)])
def test_marwil_matches_the_references_given_its_permutations(what, beta):
    """Returns up to ±30: β·adv passes the ±10 clip on both sides."""
    kw = {"beta": beta, **({"train_batch_size": 32, "num_epochs": 1} if what == "grads" else {})}
    cfg = _cfg(ref_marwil.MARWILConfig, **kw)
    batch = _samples(cfg.train_batch_size, returns_scale=30.0)
    assert (batch["returns"] > 12).any() and (batch["returns"] < -12).any()
    _policy_step(ref_marwil.make_marwil_update, marwil.make_marwil_update, cfg, what, batch)


# ---------------------------------------------------------------- CQL
def _cql_batch(N=128, seed=2):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((N, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, N).astype(np.int32),
        "rewards": rng.uniform(-1, 2, N).astype(np.float32),
        "next_obs": rng.standard_normal((N, 4)).astype(np.float32),
        "dones": (rng.uniform(size=N) < 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("what,N", [("grads", 32), ("update", 128), ("update", 100)])
def test_cql_matches_the_references_given_its_permutations(what, N):
    """N=100 with minibatches of 32: each epoch drops the permutation's
    last 4 samples (`perm[: n_mb * mb_size]`)."""
    cfg = _cfg(ref_cql.CQLConfig, target_network_update_tau=0.05,
               **({"num_epochs": 1} if what == "grads" else {}))
    ref, mod = ref_dqn.QPolicyModule(4, 3, (16, 8)), dqn.QPolicyModule(4, 3, (16, 8))
    params = _np(ref.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    params["target"] = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                                    params["target"])
    _step(ref_cql.make_cql_update, cql.make_cql_update, cfg, what, _cql_batch(N), ref, mod, params,
          lambda p: p["online"])


# ------------------------------------------------------------- datasets
def test_collect_dataset_gives_the_references_data():
    rng, ref_rng = np.random.default_rng(4), np.random.default_rng(4)
    ds = collect_dataset("CartPole-v1", lambda o: rng.integers(0, 2, len(o)), n_steps=500, num_envs=4, seed=1)
    want = ref_collect_dataset("CartPole-v1", lambda o: ref_rng.integers(0, 2, len(o)), n_steps=500, num_envs=4,
                               seed=1)
    for name in ("obs", "actions", "returns"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(want, name))
    assert ds.rewards is ds.next_obs is ds.dones is None


def test_transition_data_follows_the_env():
    """transitions=True: each step's next observation is the env's
    following one (the reset one after a done), and the returns are the
    discounted rewards down each env's stream."""
    def random_policy():
        rng = np.random.default_rng(0)
        return lambda obs: rng.integers(0, 2, len(obs))

    ds = collect_dataset("CartPole-v1", random_policy(), n_steps=400, num_envs=4, seed=3, transitions=True)
    plain = collect_dataset("CartPole-v1", random_policy(), n_steps=400, num_envs=4, seed=3)
    np.testing.assert_array_equal(ds.obs, plain.obs)
    np.testing.assert_array_equal(ds.returns, plain.returns)
    assert ds.rewards.shape == ds.dones.shape == (400,) and ds.next_obs.shape == (400, 4)
    np.testing.assert_array_equal(ds.next_obs[:-4], ds.obs[4:])
    assert (ds.rewards == 1.0).all() and ds.dones.sum() >= 10
    # Where an episode went on, the return is the reward plus γ·the next one's.
    go_on = ds.dones[:-4] == 0
    np.testing.assert_allclose(ds.returns[:-4][go_on], (1.0 + 0.99 * ds.returns[4:])[go_on], rtol=1e-6)
    with pytest.raises(ValueError, match="dones"):
        OfflineDataset(ds.obs, ds.actions, dones=ds.dones[:-1])


# ---------------------------------------------------------- validation
def test_bc_requires_offline_data():
    with pytest.raises(ValueError, match="offline_data"):
        BCConfig().environment("CartPole-v1").resources(device="cpu").build()
    with pytest.raises(ValueError, match="minibatches"):
        (BCConfig().environment("CartPole-v1").training(train_batch_size=100, minibatch_size=32)
         .offline_data(dataset=OfflineDataset(np.zeros((8, 4)), np.zeros(8))).build())


def test_marwil_requires_returns(tmp_path):
    ds = OfflineDataset(np.zeros((8, 4), np.float32), np.zeros(8, np.int64))
    with pytest.raises(ValueError, match="returns"):
        MARWILConfig().environment("CartPole-v1").offline_data(dataset=ds).resources(device="cpu").build()
    # A file without returns passes validate (no dataset yet) and fails at setup.
    path = str(tmp_path / "demos.jsonl")
    ds.write_json(path)
    with pytest.raises(ValueError, match="has none"):
        MARWILConfig().environment("CartPole-v1").offline_data(input_path=path).resources(device="cpu").build()


def test_cql_requires_transition_data():
    with pytest.raises(ValueError, match="offline_data"):
        CQLConfig().environment("CartPole-v1").resources(device="cpu").build()
    plain = collect_dataset("CartPole-v1", _expert, n_steps=64, num_envs=4)
    with pytest.raises(ValueError, match="TRANSITION"):
        CQLConfig().environment("CartPole-v1").offline_data(dataset=plain).resources(device="cpu").build()


# --------------------------------------------------------- training loops
@pytest.mark.parametrize("name", ["bc", "marwil", "cql"])
def test_three_iterations_of_each_offline_algorithm(name):
    ds = collect_dataset("CartPole-v1", _expert, n_steps=1024, num_envs=8, seed=3, transitions=True)
    config = {"bc": BCConfig, "marwil": MARWILConfig, "cql": CQLConfig}[name]()
    algo = (config.environment("CartPole-v1").training(train_batch_size=256, minibatch_size=64, num_epochs=2)
            .offline_data(dataset=ds).debugging(seed=0).resources(device="cpu").build())
    algo.config.evaluation_num_episodes = 2
    try:
        results = [algo.train() for _ in range(3)]
    finally:
        algo.stop()
    loss = {"bc": "bc_loss", "marwil": "marwil_loss", "cql": "td_loss"}[name]
    assert all(np.isfinite(r["info"]["learner"][loss]) for r in results)
    assert [r["timesteps_total"] for r in results] == [0, 0, 0]
    assert all(r["evaluation"]["episodes"] == 2 for r in results)
    if name == "cql":
        assert all(np.isfinite(r["info"]["learner"]["cql_penalty"]) for r in results)
    else:
        assert all(r["num_offline_transitions_this_iter"] == 256 for r in results)
