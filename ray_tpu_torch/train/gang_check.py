"""Multi-process SPMD gang validation — one mesh spanning processes: the
counterpart of `ray_tpu/train/gang_check.py`.

N processes, one rank each, joined into ONE torch.distributed world, build
ONE dp x fsdp mesh over it and run one train step whose collectives cross
the process boundary. (The reference joins host processes with
`jax.distributed` into one union `jax.sharding.Mesh`.)

`run_gang_step()` is process-count agnostic: the SAME function runs at one
rank or at n, and gives the same loss — that equivalence is what the tests
assert.

Run as a module to join a gang from a fresh interpreter (gloo, CPU):

    python -m ray_tpu_torch.train.gang_check <rank> <world> <store>

`<store>` is the world's `init_method` (`file:///path` or
`tcp://host:port`).
"""

from __future__ import annotations

from typing import Dict


def run_gang_step(device_type: str = "cpu") -> Dict[str, float]:
    """Build a dp x fsdp mesh over every rank of the world (dp=2 when the
    world is even, else 1), run a `shard_fn` psum and one GPT train step,
    return scalars for comparison. Call after the process group is
    initialized."""
    import torch
    import torch.distributed as dist

    from ..models.gpt import GPTConfig, init_params, make_train_step, param_shardings
    from ..optim import AdamW
    from ..parallel import P, make_mesh, place, shard_fn
    from ..collective.ops import psum as _psum

    n = dist.get_world_size()
    if n > 1 and n % 2:
        raise ValueError(f"gang check needs an even world size, got {n}")
    dp = 2 if n > 1 else 1
    mesh = make_mesh(device_type, dp=dp, fsdp=n // dp)
    data_axes = ("dp", "fsdp")
    dev = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")

    # 1) shard_fn allreduce across the mesh: rank i holds value i, the psum
    # must see every process's shard (28.0 for n=8).
    total = shard_fn(lambda x: _psum(x.sum(), data_axes), mesh, in_specs=P(data_axes), out_specs=P())(
        torch.arange(float(n), device=dev))
    psum = float(total.full_tensor())

    # 2) one GPT train step sharded dp x fsdp from the same seeded params
    # and batch at every world size.
    cfg = GPTConfig(
        vocab_size=512,
        n_layers=2,
        d_model=128,
        n_heads=4,
        d_head=32,
        d_mlp=256,
        max_seq=128,
        pos="rotary",
        rotary_dim=32,
        attn_impl="ref",
        remat=True,
        dtype=torch.float32,
    )
    shardings = param_shardings(cfg, mesh)
    params = {k: place(v, mesh, shardings[k]).detach()
              for k, v in init_params(cfg, seed=0, device=dev).items()}
    opt = AdamW(params.values(), lr=1e-3)
    B = 16
    tokens = torch.randint(0, cfg.vocab_size, (B, cfg.max_seq + 1), generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg, opt, mesh=mesh)
    _, metrics = step(params, {"tokens": tokens.to(dev)})
    loss = float(metrics["loss"])
    grad_norm = float(metrics["grad_norm"])
    assert loss == loss and loss > 0, f"bad gang loss {loss}"
    assert grad_norm > 0, "gang gradients are zero"
    return {
        "loss": loss,
        "grad_norm": grad_norm,
        "psum": psum,
        "n_global": float(n),
        "n_local": 1.0,
    }


def spawn_gang(nprocs: int = 2, store: str = "", timeout: float = 420.0):
    """Spawn `nprocs` fresh interpreters that join one gloo world through
    `store` (a `file://` path) and each run `run_gang_step`; returns the
    parsed per-process results. Stdout goes to temp files (not pipes) so a
    chatty worker can never wedge the gang on a full pipe, and every worker
    is killed on any failure path — a surviving sibling would otherwise sit
    in a collective waiting for its dead peer."""
    import json
    import os
    import subprocess
    import sys
    import tempfile
    import time

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tmp = None
    if not store:
        tmp = tempfile.mkdtemp(prefix="rtput-gang-")
        store = f"file://{tmp}/store"
    procs, logs = [], []
    try:
        for rank in range(nprocs):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.train.gang_check", str(rank), str(nprocs), store],
                stdout=log, stderr=subprocess.STDOUT, cwd=repo,
                env={**os.environ, "OMP_NUM_THREADS": "1"},
            ))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        outs = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            out = log.read()
            if p.returncode != 0:
                raise RuntimeError(f"gang worker {rank} failed:\n{out[-4000:]}")
            lines = [line for line in out.splitlines() if line.startswith("GANG_RESULT ")]
            if not lines:
                raise RuntimeError(f"no GANG_RESULT from worker {rank}:\n{out[-4000:]}")
            outs.append(json.loads(lines[-1][len("GANG_RESULT "):]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=10)
        for log in logs:
            log.close()
        if tmp is not None:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)


def _main() -> None:
    import json
    import sys
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        out = run_gang_step()
    finally:
        dist.destroy_process_group()
    print("GANG_RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    _main()
