"""Anakin — env dynamics fused with the learner on one device (Podracer §2,
arxiv 2104.06272; reference: `ray_tpu/rllib/podracer/anakin.py`).

The reference compiles one XLA program per training iteration: a
`lax.scan` over T steps of [B] batched env dynamics, then the algorithm's
update program. The port runs the same iteration on the learner's device
with no host work per env step:

    the T-step rollout of [B] batched env dynamics
      (policy forward -> action from its noise -> env.step -> auto-reset),
      captured ONCE as one CUDA graph on the card and replayed every
      iteration (eager on the CPU)
    -> time-major trajectory, entirely device-resident
    -> the algorithm's update (for PPO: GAE, the epoch loop over the
       minibatch permutations, each minibatch step its own CUDA graph —
       `make_ppo_update` unchanged)

A graph holds no RNG, so the iteration's randomness is drawn before the
replay from the driver's `torch.Generator`, in order: the action noise
([T, B, A] Gumbel for `Discrete`, [T, B, act_dim] normal for `Box`), the
reset uniforms ([T, B, *reset_shape]) and the update's permutations.
`make_anakin_step(...).with_draws` takes them, so a test can hand in the
draws JAX made from its keys. A discrete action is argmax(logits + Gumbel):
exactly `jax.random.categorical` (the reference's `module.sample`). The
host reads back the metrics and the episode-completion arrays once per
iteration.

The reference pmaps the program over devices (gradients pmean'd across
them); the port runs on one device, and more than one raises (ROADMAP
queue 1 item 6).

This is the plane for envs with a functional `TorchEnv` form
(`podracer.torch_env`); Python/numpy envs belong on Sebulba.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict

import torch

from ...device import resolve_device
from ..env.spaces import Discrete
from ..utils import optim
from ..utils.tree import to_device, to_numpy, tree_leaves, tree_map
from .torch_env import TorchEnv, autoreset_step, init_env_state, make_torch_env

AXIS = "devices"

_TRAJ_KEYS = ("obs", "actions", "logp", "values", "rewards", "dones", "ep_ret", "ep_len")
_BATCH_KEYS = ("obs", "actions", "logp", "values", "rewards", "dones", "last_obs")


def make_anakin_step(env: TorchEnv, module, update_fn, rollout_len: int):
    """Build the fused step: anakin_step(state, env_state, gen) -> (state,
    env_state, metrics, episode_outs), its draws taken from `gen` (a
    generator on the state's device), and:

    - `anakin_step.with_draws(state, env_state, draws, perms)`: the same
      step given the draws (`{"noise", "reset"}`) and the update's
      permutations;
    - `anakin_step.draw(gen, B)`: the draws of one iteration over B envs,
      and `anakin_step.perms(gen, N)`, the update's permutations of N
      samples (`update_fn.perms`);
    - `anakin_step.rollout(params, env_state, draws)`: the rollout alone as
      the step runs it (one CUDA graph on the card) and
      `anakin_step.rollout_eager`, the same rollout eager: (env_state,
      trajectory), the trajectory time-major plus `last_obs`.
    """
    T = rollout_len
    discrete = isinstance(env.action_space, Discrete)

    def act(params, obs, noise):
        dist, value = module.forward(params, obs)
        if discrete:
            action = torch.argmax(dist + noise, dim=-1)  # jax.random.categorical
        else:
            mean, log_std = dist
            action = mean + torch.exp(log_std) * noise
        return action, module.log_prob(dist, action), value

    @torch.no_grad()
    def rollout_eager(params, env_state, draws):
        est, recs = env_state, []
        for t in range(T):
            obs = env.observe_fn(est["core"])
            action, logp, value = act(params, obs, draws["noise"][t])
            est, out = autoreset_step(env, est, action, draws["reset"][t])
            recs.append({
                "obs": obs,
                "actions": action,
                "logp": logp,
                "values": value,
                "rewards": out["reward"],
                "dones": out["done"],
                "ep_ret": out["ep_ret"],
                "ep_len": out["ep_len"],
            })
        traj = {k: torch.stack([r[k] for r in recs]) for k in _TRAJ_KEYS}
        # Bootstrap view: the post-rollout observation (reset obs where an
        # episode just ended — GAE masks it through `dones`, exactly the
        # EnvRunner contract).
        traj["last_obs"] = env.observe_fn(est["core"])
        return est, traj

    graphs: dict = {}

    def rollout(params, env_state, draws):
        leaves = tree_leaves(env_state)
        if leaves[0].device.type != "cuda":
            return rollout_eager(params, env_state, draws)
        key = tuple((t.shape, t.dtype) for t in tree_leaves((params, env_state, draws)))
        if key not in graphs:
            graphs[key] = _GraphedRollout(rollout_eager, params, env_state, draws)
        return graphs[key].run(params, env_state, draws)

    def draw(gen: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        if discrete:
            from ..algorithms.dreamerv3 import gumbel

            noise = gumbel(gen, (T, B, env.action_space.n))
        else:
            noise = torch.randn((T, B) + tuple(env.action_space.shape), generator=gen, dtype=torch.float32,
                                device=gen.device)
        return {"noise": noise, "reset": env.draw_reset(gen, (T, B))}

    def with_draws(state, env_state, draws, perms):
        params, _ = state
        env_state, traj = rollout(params, env_state, draws)
        batch = {k: traj[k] for k in _BATCH_KEYS}
        state, metrics = update_fn.with_perms(state, batch, perms)
        episodes = {
            "done": traj["dones"],
            "ep_ret": traj["ep_ret"],
            "ep_len": traj["ep_len"],
        }
        return state, env_state, metrics, episodes

    def anakin_step(state, env_state, gen):
        draws = draw(gen, env_state["steps"].shape[0])
        perms = update_fn.perms(gen, T * env_state["steps"].shape[0])
        return with_draws(state, env_state, draws, perms)

    anakin_step.with_draws = with_draws
    anakin_step.draw = draw
    anakin_step.perms = update_fn.perms
    anakin_step.rollout = rollout
    anakin_step.rollout_eager = rollout_eager
    return anakin_step


class _GraphedRollout:
    """The T-step rollout captured once as one CUDA graph over static
    tensors: the params, the env state and the draws. A replay reads them,
    writes the new env state back into them and the trajectory into the
    graph's own outputs; `run` copies its arguments in and the results out.
    A capture or a replay that fails raises; nothing runs eagerly in its
    place."""

    def __init__(self, rollout_eager, params, env_state, draws):
        self._rollout = rollout_eager
        self.args = tree_map(lambda t: t.detach().clone(), (params, env_state, draws))
        device = tree_leaves(env_state)[0].device
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            # Lazy set-up (cuBLAS handles, workspaces) outside the capture;
            # the rollout is a function of its arguments.
            for _ in range(2):
                self._rollout(*self.args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with optim.graph_capture(self.graph):
            est, self.traj = self._rollout(*self.args)
            torch._foreach_copy_(tree_leaves(self.args[1]), tree_leaves(est))

    def run(self, params, env_state, draws):
        statics = tree_leaves(self.args)
        torch._foreach_copy_(statics, tree_leaves((params, env_state, draws)))
        self.graph.replay()
        return tree_map(torch.clone, self.args[1]), tree_map(torch.clone, self.traj)


class AnakinDriver:
    """The Anakin execution plane behind `Algorithm` (PPO first).

    Owns (params, opt_state) on `config.device` (None: the card) — there is
    no separate LearnerGroup; the learner IS the fused step.
    `training_step()` matches the `Algorithm.training_step` contract so
    `Algorithm.train()` drives either plane identically.
    """

    plane = "anakin"

    def __init__(self, algo):
        cfg = algo.config
        self.algo = algo
        self.module = algo.module
        self.env = make_torch_env(cfg.env, **cfg.env_config)
        self.device = resolve_device(cfg.device)
        self.num_devices = D = max(1, int(cfg.podracer_num_devices))
        self.num_envs = B = int(cfg.podracer_num_envs)
        self.rollout_len = T = int(cfg.derived_podracer_rollout_len())
        if D > 1:
            # reference: len(jax.devices()); here the cards, or 1 on the CPU.
            avail = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if D > avail:
                raise ValueError(
                    f"podracer_num_devices={D} > available devices {avail}"
                )
            if B % D != 0:
                raise ValueError(
                    f"podracer_num_envs={B} must divide over "
                    f"podracer_num_devices={D}"
                )
        # Raises for D > 1 (make_ppo_update(axis_name=): ROADMAP queue 1 item 6).
        opt, update_fn = algo._podracer_update_factory(
            axis_name=AXIS if D > 1 else None
        )
        self._opt = opt
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        # Params are drawn on the CPU from the seed, then moved (as the
        # Learner's): the same seed gives the same params on any device.
        params = to_device(self.module.init(torch.Generator().manual_seed(cfg.seed)), self.device)
        opt_state = opt.init(params)
        self._step = make_anakin_step(self.env, self.module, update_fn, T)
        self._env_state = init_env_state(self.env, self.env.draw_reset(self._gen, (B,)))
        self._state = (params, opt_state)

    # ----------------------------------------------------------- training
    def _iter_keys(self):
        """The iteration's randomness from the driver's generator, in order:
        the rollout's draws, then the update's permutations."""
        draws = self._step.draw(self._gen, self.num_envs)
        return draws, self._step.perms(self._gen, self.rollout_len * self.num_envs)

    def training_step(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self._state, self._env_state, metrics, episodes = self._step.with_draws(
            self._state, self._env_state, *self._iter_keys()
        )
        # One read-back each for the metrics and the episode arrays.
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        eps = torch.stack([episodes["done"], episodes["ep_ret"], episodes["ep_len"].float()]).cpu()
        dt = time.perf_counter() - t0

        done = eps[0] > 0
        if done.any():
            rets = eps[1][done]
            lens = eps[2][done].to(torch.int64)
            self.algo._episode_returns.extend(rets.tolist())
            self.algo._episode_lengths.extend(lens.tolist())
            self.algo._episodes_this_iter += int(done.sum())

        steps = self.rollout_len * self.num_envs
        scalars = dict(zip(metrics, values))
        _observe_metrics(self.plane, steps, dt)
        return {
            "_env_steps_this_iter": steps,
            "info": {"learner": scalars, "fused_step_seconds": dt},
        }

    # ------------------------------------------------------------ weights
    def get_weights(self):
        return to_numpy(self._state[0])

    # ----------------------------------------------------------- persist
    def save_state(self) -> bytes:
        """(params, opt_state) as CPU tensors and the generator's state: the
        card, the CPU and a respawned worker all restore them."""
        host = tree_map(lambda t: t.detach().cpu(), self._state)
        return pickle.dumps((*host, self._gen.get_state()))

    def load_state(self, blob: bytes):
        params, opt_state, gen_state = pickle.loads(blob)
        self._gen.set_state(gen_state)
        self._state = to_device((params, opt_state), self.device)

    def stop(self):
        pass


def _observe_metrics(plane: str, env_steps: int, step_seconds: float):
    """Feed the shared rllib families; never load-bearing (dropped when no
    cluster backend is attached — same rule as every other metric)."""
    try:
        from ...util.metrics import rllib_metrics

        m = rllib_metrics()
        m["rllib_env_steps_total"].inc(env_steps, tags={"plane": plane})
        m["rllib_learner_step_seconds"].observe(
            step_seconds, tags={"plane": plane}
        )
    except Exception:  # noqa: BLE001 — metrics never load-bearing
        pass
