"""Where the continuous-control, sequence-model and model-based bars fall,
by device and seed: the port's SAC, TD3 and DDPG on Pendulum-v1, its
Decision Transformer and its DreamerV3 on CartPole-v1
(`ray_tpu_torch.rllib`), at the reference tests' settings, bars and
iteration limits (`tests/test_rllib_algos.py:76-89,174-190,210-226`,
`tests/test_rllib_dt.py:44-67`, `tests/test_rllib_dreamer.py:55-67`;
`chip_smoke.py`'s `RL_BARS_II`, `PENDULUM_TRAINING`, `PENDULUM_LR`,
`DREAMER_RUNNERS`, `DREAMER_BAR`), each run to its bar or its limit.
`--seed` re-seeds the algorithm (learner, runner, replay or subsequence
sampling; DT's expert episodes keep seed 3).

    python scripts/torch_rl_bars.py --algo sac --device cpu --seed 0

Prints one JSON line: the mean reward by iteration, the iteration and env
steps of the bar (null when missed), and the seconds taken.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(algo: str, device: str, seed: int):
    import chip_smoke
    from ray_tpu_torch.rllib import DDPGConfig, DreamerV3Config, DTConfig, SACConfig, TD3Config
    from ray_tpu_torch.rllib.offline import collect_episodes

    if algo == "dreamerv3":
        return (DreamerV3Config().environment("CartPole-v1").env_runners(**chip_smoke.DREAMER_RUNNERS)
                .debugging(seed=seed).resources(device=device).build())
    if algo == "dt":
        demos = collect_episodes("CartPole-v1", chip_smoke._cartpole_expert, n_episodes=40, seed=3)
        return (DTConfig().environment("CartPole-v1")
                .training(lr=1e-3, context_length=20, embed_dim=64, num_layers=2, num_heads=2,
                          train_batch_size=256, minibatch_size=64, target_return=190.0, max_ep_len=220)
                .offline_data(demos).debugging(seed=seed).resources(device=device).build())
    config = {"sac": SACConfig, "td3": TD3Config, "ddpg": DDPGConfig}[algo]()
    return (config.environment("Pendulum-v1").env_runners(num_env_runners=0, num_envs_per_env_runner=8)
            .training(**chip_smoke.PENDULUM_TRAINING, lr=chip_smoke.PENDULUM_LR[algo])
            .debugging(seed=seed).resources(device=device).build())


def run(algo: str, device: str, seed: int) -> dict:
    import math

    import chip_smoke

    bar, limit = chip_smoke.DREAMER_BAR if algo == "dreamerv3" else chip_smoke.RL_BARS_II[algo]
    a = build(algo, device, seed)
    curve, reached, best = [], None, -math.inf
    t0 = time.perf_counter()
    for _ in range(limit):
        r = a.train()
        m = r["evaluation"]["episode_reward_mean"] if algo == "dt" else r["episode_reward_mean"]
        curve.append(round(m, 1))
        if math.isfinite(m):
            best = max(best, m)
        if best >= bar:
            reached = [r["training_iteration"], r["timesteps_total"]]
            break
    a.stop()
    return {"algo": algo, "device": device, "seed": seed, "bar": bar, "limit": limit, "reached": reached,
            "best": best, "curve": curve, "seconds": round(time.perf_counter() - t0, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=("sac", "td3", "ddpg", "dt", "dreamerv3"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.algo, args.device, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
