"""Functional (pure-torch) environments — the Anakin plane's env protocol
(reference: `ray_tpu/rllib/podracer/jax_env.py`, the pure-jnp forms).

Podracer (arxiv 2104.06272) Anakin fuses environment dynamics into the
learner's program: env.step must therefore be a *pure function* on tensors
of one device, with no host round trip, so the T-step rollout can be
captured once as one CUDA graph and replayed. The protocol is
batched-native (state trees carry a leading [N] env axis) because the
classic-control dynamics in `..env.cartpole` / `..env.pendulum` are already
written batched over an array namespace — this plane calls the SAME
functions with `xp=torch` that the numpy `VectorEnv`s call with
`xp=numpy`, so dynamics parity holds by construction and
`tests/test_torch_podracer_env.py` guards the wrapper semantics (reset
distribution, auto-reset, step accounting).

Protocol (`TorchEnv`):

    reset_fn(u)           -> core state tree with leading [n]
    observe_fn(state)     -> [n, obs_dim] float32
    step_fn(state, action)-> (new_state, reward [n], terminated [n] bool)

The one divergence from the reference: `reset_fn` takes its uniforms `u`
([n, *reset_shape], in [0, 1)) as an input and no key. A CUDA graph holds
no RNG, so every draw of a rollout is made before it runs; and a test can
hand in the uniforms JAX drew (`jax.random.uniform(key, shape)` with the
default bounds), which `reset_fn` maps to the reference's bounds as
`jax.random.uniform(key, shape, minval, maxval)` does:
max(lo, u·(hi − lo) + lo) in f32.

Episode bookkeeping (step counters, returns, truncation, auto-reset) is NOT
the env's job — `autoreset_step` wraps any TorchEnv with the exact
semantics the numpy `VectorEnv`s implement: step counters increment before
the done check, truncation fires at max_episode_steps on non-terminated
envs, finished envs are reset in place (the returned observation of a
finished env is its RESET observation), and the pre-reset episode
return/length are exposed so the driver can report completed episodes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..env import cartpole as np_cartpole
from ..env import pendulum as np_pendulum
from ..env.spaces import Box, Discrete
from ..utils.tree import tree_map


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Unit uniforms to [lo, hi) as `jax.random.uniform(minval=lo,
    maxval=hi)` maps its unit floats, in f32: max(lo, u·(hi − lo) + lo)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = float(hi32 - lo32)  # the f32 difference, as JAX's (maxval - minval)
    return torch.clamp_min(u * span + float(lo32), float(lo32))


class TorchEnv:
    """Base protocol: subclasses provide pure batched reset/observe/step.

    `observation_space`/`action_space` mirror the numpy VectorEnv surface so
    `Algorithm._make_module` sizes the policy identically for both planes.
    `reset_shape` is the trailing shape of one env's reset uniforms.
    """

    max_episode_steps: int = 1000
    observation_space: Any = None
    action_space: Any = None
    reset_shape: Tuple[int, ...] = ()

    def reset_fn(self, u):
        raise NotImplementedError

    def observe_fn(self, state):
        raise NotImplementedError

    def step_fn(self, state, action):
        raise NotImplementedError

    def draw_reset(self, gen: torch.Generator, lead: Tuple[int, ...]) -> torch.Tensor:
        """Unit uniforms [*lead, *reset_shape] from `gen`, on its device."""
        return torch.rand(tuple(lead) + tuple(self.reset_shape), generator=gen, dtype=torch.float32,
                          device=gen.device)


class TorchCartPole(TorchEnv):
    """CartPole-v1 in torch — dynamics shared with `env.cartpole`."""

    reset_shape = (4,)

    def __init__(self, max_episode_steps: int = 500):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(-np.inf, np.inf, (4,))
        self.action_space = Discrete(2)

    def reset_fn(self, u):
        return _uniform(u, -np_cartpole.RESET_BOUND, np_cartpole.RESET_BOUND)

    def observe_fn(self, state):
        return state.to(torch.float32)

    def step_fn(self, state, action):
        new_state = np_cartpole.cartpole_step(torch, state, action)
        reward = torch.ones(state.shape[0], dtype=torch.float32, device=state.device)
        terminated = np_cartpole.cartpole_terminated(torch, new_state)
        return new_state, reward, terminated


class TorchPendulum(TorchEnv):
    """Pendulum-v1 in torch — dynamics shared with `env.pendulum`.

    Core state is [n, 2] (theta, theta_dot); never terminates, truncation
    only. Its reset uniforms are [n, 2]: column 0 draws theta, column 1
    theta_dot (the reference's two keys of `jax.random.split(key)`).
    """

    reset_shape = (2,)

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(-np.inf, np.inf, (3,))
        self.action_space = Box(
            -np_pendulum.MAX_TORQUE, np_pendulum.MAX_TORQUE, (1,)
        )

    def reset_fn(self, u):
        theta = _uniform(u[:, 0], -np_pendulum.RESET_THETA_BOUND, np_pendulum.RESET_THETA_BOUND)
        theta_dot = _uniform(u[:, 1], -np_pendulum.RESET_THETADOT_BOUND, np_pendulum.RESET_THETADOT_BOUND)
        return torch.stack([theta, theta_dot], dim=1)

    def observe_fn(self, state):
        return np_pendulum.pendulum_obs(
            torch, state[:, 0], state[:, 1]
        ).to(torch.float32)

    def step_fn(self, state, action):
        u = action.to(torch.float32).reshape(state.shape[0])
        theta, theta_dot, cost = np_pendulum.pendulum_step(
            torch, state[:, 0], state[:, 1], u
        )
        new_state = torch.stack([theta, theta_dot], dim=1)
        terminated = torch.zeros(state.shape[0], dtype=torch.bool, device=state.device)
        return new_state, (-cost).to(torch.float32), terminated


# --------------------------------------------------------------------------
# Auto-reset wrapper state: exactly the VectorEnv bookkeeping, as a tree.
# --------------------------------------------------------------------------
def init_env_state(env: TorchEnv, u) -> Dict[str, Any]:
    """Fresh wrapper state from reset uniforms `u` ([n, *reset_shape]): core
    env state + per-env step/return counters, on `u`'s device."""
    n = u.shape[0]
    return {
        "core": env.reset_fn(u),
        "steps": torch.zeros(n, dtype=torch.int32, device=u.device),
        "ep_ret": torch.zeros(n, dtype=torch.float32, device=u.device),
    }


def autoreset_step(env: TorchEnv, est: Dict[str, Any], action, u):
    """One wrapped step with VectorEnv-parity auto-reset semantics; `u` are
    this step's reset uniforms ([n, *reset_shape]).

    Returns (new_est, out) where `out` carries everything a rollout records:
      reward, terminated, truncated, done (float32 — the GAE mask),
      ep_ret / ep_len (the PRE-reset totals; only meaningful where done).
    Finished envs are already reset inside `new_est` — observing it yields
    the reset observation, matching the numpy env's step return. Nothing
    here reads a value back to the host, so a CUDA graph can capture it.
    """
    n = est["steps"].shape[0]
    core, reward, terminated = env.step_fn(est["core"], action)
    steps = est["steps"] + 1
    truncated = (~terminated) & (steps >= env.max_episode_steps)
    done = terminated | truncated
    ep_ret = est["ep_ret"] + reward

    fresh = env.reset_fn(u)
    # Core may be any tree with leading [n] leaves; blend per leaf.
    new_core = tree_map(
        lambda f, c: torch.where(done.reshape((n,) + (1,) * (c.ndim - 1)), f, c),
        fresh, core,
    )
    new_est = {
        "core": new_core,
        "steps": torch.where(done, torch.zeros_like(steps), steps),
        "ep_ret": torch.where(done, torch.zeros_like(ep_ret), ep_ret),
    }
    out = {
        "reward": reward,
        "terminated": terminated,
        "truncated": truncated,
        "done": done.to(torch.float32),
        "ep_ret": ep_ret,
        "ep_len": steps,
    }
    return new_est, out


# --------------------------------------------------------------------------
# Registry (parallel to ..env's numpy registry; same names resolve to the
# functional forms so one AlgorithmConfig.environment() drives either plane)
# --------------------------------------------------------------------------
_TORCH_ENV_REGISTRY: Dict[str, Callable[..., TorchEnv]] = {}


def register_torch_env(name: str, ctor: Callable[..., TorchEnv]) -> None:
    _TORCH_ENV_REGISTRY[name] = ctor


def make_torch_env(name: str, **kwargs) -> TorchEnv:
    if name not in _TORCH_ENV_REGISTRY:
        raise KeyError(
            f"No functional (TorchEnv) form registered for {name!r} — the "
            f"Anakin plane needs pure-torch dynamics. Registered: "
            f"{sorted(_TORCH_ENV_REGISTRY)}. Python-loop envs belong on the "
            "Sebulba plane (config.podracer('sebulba'))."
        )
    return _TORCH_ENV_REGISTRY[name](**kwargs)


def torch_env_registered(name: str) -> bool:
    return name in _TORCH_ENV_REGISTRY


register_torch_env("CartPole-v1", TorchCartPole)
register_torch_env("Pendulum-v1", TorchPendulum)
