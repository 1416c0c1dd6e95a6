"""Where a cold GPU worker's boot goes, on the machine with the card.

    python scripts/torch_worker_boot.py [--runs 3] [--out FILE]

Times, each in a fresh interpreter (`--runs` times, the first cold):
`import torch`; `import torch` then the first CUDA op (the context);
`import ray_tpu_torch.core.worker_main` (the worker's own imports, torch
included). Then, in a port cluster (`ray_tpu_torch.init()`), the wall from
asking for an actor to its first answer, for a CPU actor (forked from the
template) and for a `num_gpus=1` actor (a cold GPU worker), each twice.
Prints one JSON object (and writes it to `--out`)."""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPETS = {
    "import_torch": "import torch",
    "import_torch_and_cuda": "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()",
    "import_worker_main": "import ray_tpu_torch.core.worker_main",
}


def _interpreter_s(code: str) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    return time.perf_counter() - t0


class Probe:
    def ready(self):
        return os.getpid()


def _actor_s(rt, **options) -> float:
    t0 = time.perf_counter()
    actor = rt.remote(**options)(Probe).remote() if options else rt.remote(Probe).remote()
    rt.get(actor.ready.remote(), timeout=300)
    wall = time.perf_counter() - t0
    rt.kill(actor)
    return wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    out = {"interpreter_s": {name: [round(_interpreter_s(code), 3) for _ in range(args.runs)]
                             for name, code in SNIPPETS.items()}}
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init(log_to_driver=False)
    try:
        out["cluster_up_s"] = round(time.perf_counter() - t0, 3)
        out["resources"] = rt.cluster_resources()
        out["cpu_actor_s"] = [round(_actor_s(rt), 3) for _ in range(2)]
        if out["resources"].get("GPU"):
            out["gpu_actor_s"] = [round(_actor_s(rt, num_gpus=1), 3) for _ in range(2)]
    finally:
        rt.shutdown()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
