"""ray_tpu_torch.rllib — reinforcement learning library (reference: `rllib/`).

The port of the JAX reference's RLlib (`ray_tpu/rllib/__init__.py:1-14`,
the redesign of RLlib's new API stack: `rllib/core/learner/learner.py:95`,
`rllib/core/rl_module/rl_module.py:228`, `rllib/env/env_runner.py:15`):

* **EnvRunner** actors vectorize environments in numpy and run the policy
  forward pass in torch, one call per vectorized step, on the runner's
  device — the card for the local runner, the CPU for remote runners.
* **Learner** updates run on the learner's device (the card): advantage
  estimation, minibatch permutation, the epoch loop and the optimizer, op
  for op the reference's jitted program.

The port has PPO and multi-agent PPO with the env API, the runners,
connectors, offline data and replay buffers, the discrete-action
algorithms (IMPALA, DQN, APPO, BC, MARWIL, A2C, Ape-X DQN, CQL), SAC,
TD3, DDPG, the Decision Transformer (DT) and DreamerV3, and the podracer
planes: Anakin (env dynamics and the update fused on one device, the
rollout one CUDA graph) and Sebulba (a CPU actor gang feeding a learner
over the block transport).
"""

from .algorithms.algorithm import Algorithm
from .algorithms.algorithm_config import AlgorithmConfig
from .algorithms.ppo import PPO, PPOConfig
from .algorithms.impala import IMPALA, IMPALAConfig
from .algorithms.dqn import DQN, DQNConfig
from .algorithms.sac import SAC, SACConfig
from .algorithms.appo import APPO, APPOConfig
from .algorithms.bc import BC, BCConfig
from .algorithms.marwil import MARWIL, MARWILConfig
from .algorithms.td3 import TD3, TD3Config
from .algorithms.ddpg import DDPG, DDPGConfig
from .algorithms.a2c import A2C, A2CConfig
from .algorithms.apex_dqn import ApexDQN, ApexDQNConfig
from .algorithms.cql import CQL, CQLConfig
from .algorithms.dt import DT, DTConfig
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
from .algorithms.dreamerv3 import DreamerV3, DreamerV3Config
# reference: no `connectors` import here (`ray_tpu/rllib/__init__.py:34-35`); the port exports it.
from . import connectors
from . import offline
from . import podracer
from .env import register_env, make_env
from .env.env_runner import EnvRunner
from .env.multi_agent import MultiAgentEnv, SharedPolicyVectorEnv, make_multi_agent
from .utils import replay_buffers

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "PPO",
    "PPOConfig",
    "IMPALA",
    "IMPALAConfig",
    "DQN",
    "DQNConfig",
    "SAC",
    "SACConfig",
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "MARWIL",
    "MARWILConfig",
    "TD3",
    "TD3Config",
    "DDPG",
    "DDPGConfig",
    "A2C",
    "A2CConfig",
    "ApexDQN",
    "ApexDQNConfig",
    "CQL",
    "CQLConfig",
    "DT",
    "DTConfig",
    "MultiAgentPPO",
    "DreamerV3",
    "DreamerV3Config",
    "MultiAgentPPOConfig",
    "connectors",  # reference: not in `__all__` (`:74-75`)
    "offline",
    "podracer",
    "register_env",
    "make_env",
    "EnvRunner",
    "MultiAgentEnv",
    "SharedPolicyVectorEnv",
    "make_multi_agent",
    "replay_buffers",
]
