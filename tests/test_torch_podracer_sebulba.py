"""The port's Sebulba plane (`ray_tpu_torch/rllib/podracer/sebulba.py`): an
actor gang of CPU actors feeding a learner over the block transport, with
GangSupervisor elasticity (chaos: SIGKILL an actor) — the reference's two
tests (`tests/test_podracer_sebulba.py`) in one port cluster, the learner on
the CPU; and the learner member's update against the port's in-process PPO
update given the same batch and permutations, bit for bit.

Batch shape (32 envs/actor x 128 steps ~ 90KB/frame) is ABOVE the store's
inline threshold so trajectory frames ride arena segments — the transport
stats asserted below show that this is the block transport, not pickled
RPC returns. The transport itself is a copy of the reference's
(`tests/test_torch_isolation.py`)."""

import os
import pickle
import signal

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import PPOConfig
from ray_tpu_torch.rllib.algorithms import ppo
from ray_tpu_torch.rllib.core import rl_module
from ray_tpu_torch.rllib.podracer.sebulba import _LearnerMember
from ray_tpu_torch.rllib.utils import optim
from ray_tpu_torch.rllib.utils.tree import to_numpy, tree_leaves

ENVS_PER_ACTOR = 32
ROLLOUT = 128
ACTORS = 2
STEPS_PER_ITER = ENVS_PER_ACTOR * ROLLOUT * ACTORS


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sebulba_cluster():
    # 2 actors + 1 learner at one CPU each, plus slack. Module-scoped: one
    # cluster boot serves both tests (the chaos test kills gang WORKERS,
    # never the cluster).
    rt.init(num_cpus=6)
    yield
    rt.shutdown()


def _sebulba_cfg(**over):
    pod = dict(
        num_actors=ACTORS,
        envs_per_actor=ENVS_PER_ACTOR,
        rollout_len=ROLLOUT,
        min_actors=1,
        max_restarts=3,
    )
    pod.update(over)
    return (
        PPOConfig()
        .environment("CartPole-v1")
        .training(
            train_batch_size=STEPS_PER_ITER,
            minibatch_size=2048,
            num_epochs=2,
            lr=1e-3,
        )
        .debugging(seed=11)
        .podracer("sebulba", **pod)
        .resources(device="cpu")
    )


@pytest.mark.cluster
def test_sebulba_trains_over_block_transport(sebulba_cluster):
    algo = _sebulba_cfg().build()
    try:
        for i in range(2):
            result = algo.train()
            assert result["timesteps_total"] == (i + 1) * STEPS_PER_ITER
            assert np.isfinite(result["info"]["learner"]["total_loss"])
            assert result["info"]["learner_step_seconds"] > 0
            assert result["info"]["num_actors"] == ACTORS

        stats = algo._podracer.transport_stats
        # Acceptance: frames ride arena segments, not pickled RPC returns.
        for actor_stats in stats["actors"]:
            assert actor_stats["pub_arena"] >= 1, stats
            assert actor_stats["pub_inline"] == 0, stats
        learner = stats["learner"]
        assert learner["fetch_local"] + learner["fetch_span"] >= ACTORS, stats
        assert learner["fetch_inline"] == 0, stats

        # Episode stats flow back through the actors' RPC replies.
        assert result["episodes_this_iter"] > 0
        assert np.isfinite(result["episode_reward_mean"])

        # The learner state round-trips (the reshape restore path): CPU
        # tensors and the generator's state; the driver's weights are its
        # params as numpy.
        blob = algo._podracer.save_state()
        assert isinstance(blob, bytes) and len(blob) > 0
        params, _, gen_state = pickle.loads(blob)
        assert all(t.device.type == "cpu" for t in tree_leaves(params)) and isinstance(gen_state, torch.Tensor)
        for a, b in zip(tree_leaves(algo._weights), tree_leaves(params)):
            np.testing.assert_array_equal(a, b.numpy())
    finally:
        algo.stop()


@pytest.mark.cluster
@pytest.mark.chaos
def test_sebulba_actor_kill_recovers_with_continuous_steps(sebulba_cluster):
    """SIGKILL one gang actor -> the collect RPC fails -> supervisor aborts
    the mesh, reshapes, respawns from the learner state blob, and the SAME
    train() call returns — with the env-step counter continuous."""
    algo = _sebulba_cfg().build()
    try:
        r1 = algo.train()
        assert r1["timesteps_total"] == STEPS_PER_ITER
        sup = algo._podracer._supervisor
        assert sup.attempts == 0

        victim = algo._podracer.gang.actors[0]
        victim_pid = rt.get(victim.pid.remote(), timeout=30)
        os.kill(victim_pid, signal.SIGKILL)

        # This train() hits the dead actor mid-iteration, recovers inside
        # training_step, and completes the retried iteration.
        r2 = algo.train()
        assert sup.attempts == 1
        assert r2["timesteps_total"] > r1["timesteps_total"]
        # The retried iteration's steps are counted ONCE (continuity: the
        # counter grows by exactly one iteration's worth for the reshaped
        # gang size).
        n_after = r2["info"]["num_actors"]
        assert 1 <= n_after <= ACTORS
        delta = r2["timesteps_total"] - r1["timesteps_total"]
        assert delta == ENVS_PER_ACTOR * ROLLOUT * n_after

        # And the gang keeps training after recovery (fresh actors got
        # params via the first-iteration-after-spawn forced broadcast).
        r3 = algo.train()
        assert r3["timesteps_total"] > r2["timesteps_total"]
        assert np.isfinite(r3["info"]["learner"]["total_loss"])
        # Transport still rides the arena post-reshape.
        for actor_stats in algo._podracer.transport_stats["actors"]:
            assert actor_stats["pub_arena"] >= 1
    finally:
        algo.stop()


def _fragment(seed: int, T: int = 8, B: int = 4) -> dict:
    """One actor's time-major fragment, as an EnvRunner returns it."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((T, B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
            "logp": np.full((T, B), -0.69, np.float32),
            "values": rng.standard_normal((T, B)).astype(np.float32),
            "rewards": np.ones((T, B), np.float32),
            "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
            "last_obs": rng.standard_normal((B, 4)).astype(np.float32)}


def _member(cfg, mod, opt, update, params, blob=None) -> _LearnerMember:
    return _LearnerMember(cloudpickle.dumps(dict(
        module=mod, opt=opt, update_fn=update, seed=cfg.seed, init_params=params, device="cpu",
        state_blob=blob, channel_timeout_s=5.0)))


def test_learner_member_update_equals_the_in_process_update():
    """The learner member's update of two actors' fragments (concatenated
    along the env axis, `last_obs` along its first) equals the port's PPO
    update of the concatenated batch given the permutations the member's
    generator draws, bit for bit; a member respawned from the state blob
    then updates as the first one does."""
    cfg = PPOConfig().training(num_epochs=2, minibatch_size=16, lr=1e-3).debugging(seed=11)
    mod = rl_module.DiscretePolicyModule(4, 2, (8,))
    opt = optim.make_optimizer(cfg)
    update = ppo.make_ppo_update(mod, opt, cfg)
    params = to_numpy(mod.init(torch.Generator().manual_seed(0)))
    frags = [_fragment(1), _fragment(2)]
    member = _member(cfg, mod, opt, update, params)
    out = member.update([{"inline": f} for f in frags])
    assert out["env_steps"] == 8 * 8 and member._transport.stats["fetch_inline"] == 2

    batch = {k: torch.from_numpy(np.concatenate([f[k] for f in frags], axis=0 if k == "last_obs" else 1))
             for k in frags[0]}
    assert batch["obs"].shape == (8, 8, 4) and batch["last_obs"].shape == (8, 4)
    tparams = rl_module.params_from_numpy(params, "cpu")
    perms = update.perms(torch.Generator().manual_seed(cfg.seed), 64)
    (want_p, _), want_m = update.with_perms((tparams, opt.init(tparams)), batch, perms)
    for a, b in zip(tree_leaves(member.get_weights()), tree_leaves(want_p)):
        np.testing.assert_array_equal(a, b.numpy())
    assert out["metrics"] == {k: float(v) for k, v in want_m.items()}

    # Respawned from the blob (the reshape path): the next update equals the
    # first member's next update.
    again = _member(cfg, mod, opt, update, params, blob=out["state"])
    nxt = [{"inline": _fragment(3)}]
    assert again.update(nxt)["metrics"] == member.update(nxt)["metrics"]
    for a, b in zip(tree_leaves(again.get_weights()), tree_leaves(member.get_weights())):
        np.testing.assert_array_equal(a, b)
