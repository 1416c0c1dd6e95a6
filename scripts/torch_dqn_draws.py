"""Where DQN's CartPole bar falls, by the device and by the stream of
epsilon-greedy draws: the port's DQN (`ray_tpu_torch.rllib.DQN`) at the
reference test's settings, seed and bar (`tests/test_rllib_algos.py:37-48`:
mean reward 130 within 80 iterations).

Runs, each to the bar or the limit:
- `own`: the learner and the local runner on `--device`, the runner drawing
  from its own generator on that device (what `chip_smoke.py` runs);
- `cpu_draws` (a card only): the same, but the runner's epsilon-greedy draws
  come from a CPU `torch.Generator` seeded as the CPU run's, so the card
  sees the CPU run's draws;
- `stream <s>`: `own` with the runner's generator re-seeded to `s` (the
  learner, the env and the replay sampling keep seed 0).

Each run records the iteration of the bar, the best mean reward, and a
CRC32 of every iteration's sampled actions, so two runs' action streams can
be compared iteration by iteration (`--compare a.json b.json` prints the
first iteration where they part).

Run on the card and the CPU at once, then compare:

    python scripts/torch_dqn_draws.py --device cuda --out chiprun_out/dqn_cuda.json &
    python scripts/torch_dqn_draws.py --device cpu --out chiprun_out/dqn_cpu.json; wait
    python scripts/torch_dqn_draws.py --compare chiprun_out/dqn_cpu.json chiprun_out/dqn_cuda.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BAR, LIMIT = 130.0, 80


def _cpu_draw_sample(gen, dist):
    """`QPolicyModule.sample` with the draws made on the generator's device
    (the CPU) in the same order, then moved to the q-values' device."""
    import torch

    qvals, eps = dist
    greedy = qvals.argmax(dim=-1)
    explore = torch.rand(greedy.shape, generator=gen, device=gen.device).to(qvals.device) < eps
    random = torch.randint(0, qvals.shape[-1], greedy.shape, generator=gen, device=gen.device).to(qvals.device)
    return torch.where(explore, random, greedy).to(torch.int32)


def run(device: str, draws: str = "own", stream: int | None = None, max_iters: int = LIMIT) -> dict:
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
            .training(train_batch_size=512, learning_starts=1000, num_grad_steps=64,
                      epsilon_decay_steps=10_000, lr=5e-4)
            .debugging(seed=0).resources(device=device).build())
    runner = algo._local_runner
    if draws == "cpu_draws":
        runner._gen = torch.Generator().manual_seed(0)
        runner.module.sample = _cpu_draw_sample
    if stream is not None:
        runner._gen.manual_seed(stream)
    crcs = []
    sample = runner.sample

    def recording_sample(params):
        batch = sample(params)
        crcs.append(zlib.crc32(np.ascontiguousarray(batch["actions"]).tobytes()))
        return batch

    runner.sample = recording_sample
    best, at, t0 = -np.inf, None, time.perf_counter()
    for i in range(1, max_iters + 1):
        m = algo.train()["episode_reward_mean"]
        if np.isfinite(m):
            best = max(best, float(m))
        if best >= BAR:
            at = i
            break
    algo.stop()
    return {"device": device, "draws": draws, "stream": stream, "bar_at": at, "best": best,
            "iterations": len(crcs), "s": round(time.perf_counter() - t0, 1), "action_crc": crcs}


def compare(a: dict, b: dict) -> int | None:
    """The first iteration (1-based) whose sampled actions differ, else None."""
    for i, (x, y) in enumerate(zip(a["action_crc"], b["action_crc"]), 1):
        if x != y:
            return i
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", default="1,2,3,4", help="runner seeds of the stream runs ('' for none)")
    ap.add_argument("--max-iters", type=int, default=LIMIT)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        ka = {(r["draws"], r["stream"]): r for r in a["runs"]}
        for r in b["runs"]:
            key = ("own", r["stream"]) if r["draws"] == "cpu_draws" else (r["draws"], r["stream"])
            if key in ka:
                print(json.dumps({"a": [a["device"], *key], "b": [b["device"], r["draws"], r["stream"]],
                                  "bar_at": [ka[key]["bar_at"], r["bar_at"]],
                                  "actions_first_differ_at": compare(ka[key], r)}))
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    plan = [("own", None)] + ([("cpu_draws", None)] if args.device != "cpu" else [])
    plan += [("own", int(s)) for s in args.streams.split(",") if s]
    runs = []
    for draws, stream in plan:
        r = run(args.device, draws, stream, args.max_iters)
        runs.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "action_crc"}), flush=True)
    out = {"device": args.device, "name": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
           "torch": torch.__version__, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
