"""Environment API + registry (reference: `rllib/env/`).

The reference delegates to gymnasium; this image has no gym, so classic
control environments are implemented natively — and *vectorized in numpy*
from the start, which is the shape the TPU stack wants anyway (EnvRunner
actors step [N]-env batches, the policy forward is one XLA call per batch).

API is gymnasium-flavored:
    reset(seed) -> (obs, info);  step(a) -> (obs, rew, terminated, truncated, info)
Vector envs auto-reset finished sub-envs and report completed episode
returns/lengths in `info`.

Dynamics live in xp-generic module functions (`cartpole.cartpole_step`,
`pendulum.pendulum_step`, ... parameterized over numpy|jnp) so the numpy
VectorEnvs here and the traceable `podracer.jax_env` forms share ONE
implementation — `tests/test_podracer_env_parity.py` holds them equal.
"""

from __future__ import annotations

from typing import Callable, Dict

from .spaces import Box, Discrete, Space
from .vector import VectorEnv

_ENV_REGISTRY: Dict[str, Callable[..., VectorEnv]] = {}


def register_env(name: str, ctor: Callable[..., VectorEnv]) -> None:
    """Register a vector-env constructor: ctor(num_envs, **kwargs) -> VectorEnv.

    Reference analog: `ray.tune.registry.register_env` (used throughout
    rllib/algorithms) — here envs are registered directly with the RL lib.
    """
    _ENV_REGISTRY[name] = ctor


def make_env(name: str, num_envs: int = 1, **kwargs) -> VectorEnv:
    if name not in _ENV_REGISTRY:
        raise KeyError(
            f"Unknown env {name!r}. Registered: {sorted(_ENV_REGISTRY)}. "
            "Use register_env(name, ctor) for custom environments."
        )
    return _ENV_REGISTRY[name](num_envs, **kwargs)


def _register_builtins():
    from .cartpole import VectorCartPole
    from .pendulum import VectorPendulum

    register_env("CartPole-v1", VectorCartPole)
    register_env("Pendulum-v1", VectorPendulum)

    def _multi_cartpole(num_envs, num_agents: int = 2, **kwargs):
        # Shared-policy multi-agent CartPole: num_envs policy slots total.
        from .multi_agent import SharedPolicyVectorEnv, make_multi_agent

        # Slots come in whole instances (instances × agents). num_envs below
        # one instance (e.g. the space-probe's num_envs=1) rounds up to one.
        if num_envs > num_agents and num_envs % num_agents != 0:
            raise ValueError(
                f"MultiCartPole needs num_envs ({num_envs}) divisible by "
                f"num_agents ({num_agents}) — slots are instances × agents"
            )
        ma_cls = make_multi_agent(VectorCartPole, num_agents=num_agents)
        return SharedPolicyVectorEnv(lambda: ma_cls(**kwargs), max(num_envs // num_agents, 1))

    register_env("MultiCartPole", _multi_cartpole)


_register_builtins()

__all__ = [
    "Box",
    "Discrete",
    "Space",
    "VectorEnv",
    "register_env",
    "make_env",
]
