"""Podracer execution planes (arxiv 2104.06272) behind one config surface.

`AlgorithmConfig.podracer("anakin")` fuses batched env dynamics into the
learner's program on one device (`anakin.AnakinDriver` + the pure-torch
envs in `torch_env`; reference: the pure-jnp envs in `jax_env` fused into
one jit); `AlgorithmConfig.podracer("sebulba")` splits a numpy-env actor
gang from the learner, trajectories riding the block transport and params
returning over compiled-DAG channels (`sebulba.SebulbaDriver`).
"""

# reference: `from .jax_env import (JaxCartPole, JaxEnv, JaxPendulum, ...,
# jax_env_registered, make_jax_env, register_jax_env)` — the port's names.
from .torch_env import (
    TorchCartPole,
    TorchEnv,
    TorchPendulum,
    autoreset_step,
    init_env_state,
    make_torch_env,
    register_torch_env,
    torch_env_registered,
)

__all__ = [
    # reference: "JaxCartPole", "JaxEnv", "JaxPendulum"
    "TorchCartPole",
    "TorchEnv",
    "TorchPendulum",
    "AnakinDriver",
    "SebulbaDriver",
    "autoreset_step",
    "init_env_state",
    # reference: "jax_env_registered", "make_jax_env", "register_jax_env"
    "make_torch_env",
    "register_torch_env",
    "torch_env_registered",
]


def __getattr__(name):  # lazy: importing torch_env (reference: jax_env) must not pull in transport
    if name == "AnakinDriver":
        from .anakin import AnakinDriver

        return AnakinDriver
    if name == "SebulbaDriver":
        from .sebulba import SebulbaDriver

        return SebulbaDriver
    raise AttributeError(name)
