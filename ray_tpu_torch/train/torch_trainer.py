"""TorchTrainer — data-parallel training on a gang of workers joined in one
torch.distributed world: NCCL between workers that see a card, gloo
between CPU workers.

The port of two reference files: `ray_tpu/train/jax_trainer.py` (the
accelerator trainer: the gang's coordinator env, `JaxTrainer`,
`jax_utils.get_mesh`) and `ray_tpu/train/torch_trainer.py` (the CPU gloo
trainer: `TorchBackend`, `prepare_model`, `prepare_data_loader`,
`get_device`). Reference analog: Ray's `python/ray/train/torch/`
(`_TorchBackend.on_start` → `dist.init_process_group` in
`torch/config.py:106,148`; `prepare_model`/`prepare_data_loader` in
`train_loop_utils.py:74,369`).

One worker runs per card (`ScalingConfig(use_gpu=True)` places each on the
GPU worker kind). Inside `train_loop_per_worker`:

    from ray_tpu_torch.train import torch as tt
    mesh = tt.torch_utils.get_mesh()       # joins the world, dp over the gang
    step = gpt.make_train_step(cfg, opt, mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from .config import RunConfig, ScalingConfig
from .data_parallel_trainer import CollectiveBackend, DataParallelTrainer


class TorchBackend(CollectiveBackend):
    """Gives every worker the gang's MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE / LOCAL_RANK; workers join with `prepare()` (or
    `torch_utils.get_mesh()`). Worker 0's address and a free port on its
    host make the store. Unlike the reference's `JaxBackend.on_start`, which
    returns early for a gang of one, this runs at world size 1 too: the
    mesh needs a process group even then."""

    def on_start(self, worker_group, scaling):
        super().on_start(worker_group, scaling)
        n = len(worker_group)
        ip, port = worker_group.execute_single(0, _coordinator_binding)
        envs = [
            {
                "MASTER_ADDR": ip,
                "MASTER_PORT": str(port),
                "RANK": str(i),
                "WORLD_SIZE": str(n),
                # The worker's card among those it sees (one machine: the
                # rank; the reference sets "0", its workers being CPU-only).
                "LOCAL_RANK": str(i),
            }
            for i in range(n)
        ]
        worker_group.set_env_all(envs)

    def on_shutdown(self, worker_group):
        try:
            worker_group.execute_all(_leave_process_group)
        except Exception:  # noqa: BLE001 — a member already gone
            pass


def _coordinator_binding():
    """Runs ON worker 0: its routable IP + a free port on that host. The
    route probe sends nothing; on a host without a route it fails and the
    store binds 127.0.0.1."""
    import socket

    ip = "127.0.0.1"
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))  # no packets sent; just picks a route
        ip = s.getsockname()[0]
    except OSError:
        pass
    finally:
        s.close()
    ps = socket.socket()
    ps.bind((ip if ip != "127.0.0.1" else "127.0.0.1", 0))
    port = ps.getsockname()[1]
    ps.close()
    return ip, port


class TorchTrainer(DataParallelTrainer):
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict] = None,
        resume_from_checkpoint=None,
    ):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend=TorchBackend(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )


# ------------------------------------------------------------------- utils
class torch_utils:
    """Worker-side helpers, the counterpart of the reference's `jax_utils`."""

    @staticmethod
    def maybe_init_distributed() -> bool:
        """Join the gang's world (see `prepare`); True once joined."""
        return prepare()

    @staticmethod
    def get_mesh(device_type: Optional[str] = None, **axis_sizes):
        """The gang-wide `DeviceMesh` (default: pure dp over every rank),
        after joining the world. `device_type` defaults to "cuda", which
        raises on a worker that sees no card; ask for "cpu" there."""
        from ..parallel import make_mesh

        prepare()
        if not axis_sizes:
            axis_sizes = {"dp": -1}
        return make_mesh(device_type or "cuda", **axis_sizes)


# ------------------------------------------------------- in-loop utilities
def _gang_env() -> Dict[str, str]:
    """The worker's gang env. The session copy is authoritative: local-mode
    workers share one process, and os.environ holds the last one's."""
    from .session import get_context

    env = dict(os.environ)
    env.update(get_context().env_vars)
    return env


_JOINED: dict = {}


def prepare() -> bool:
    """Join the gang's torch.distributed world from its env (call once at
    the top of train_loop_per_worker; `get_mesh` calls it): NCCL on a worker
    that sees a card, after `torch.cuda.set_device(LOCAL_RANK)`, gloo on a
    CPU worker. Idempotent for the same gang; a process still in another
    gang's world (local mode runs several in one) leaves it first."""
    import torch
    import torch.distributed as dist

    env = _gang_env()
    if "MASTER_ADDR" not in env:
        raise RuntimeError("prepare() needs the gang env (MASTER_ADDR, ...): run it inside a "
                           "TorchTrainer's train_loop_per_worker")
    gang = (env["MASTER_ADDR"], env["MASTER_PORT"], int(env["RANK"]), int(env["WORLD_SIZE"]))
    if dist.is_initialized():
        if _JOINED.get("gang") == gang:
            return True
        _leave_process_group()
    addr, port, rank, world = gang
    kwargs = {}
    if torch.cuda.is_available():
        local = int(env.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
                            **kwargs)
    _JOINED["gang"] = gang
    return True


def _leave_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _JOINED.clear()
    return True


def prepare_model(model):
    """The model on this worker's device, wrapped in DDP when the gang has
    more than one rank (`device_ids` on a GPU worker). Reference:
    `prepare_model`, `train_loop_utils.py:74`."""
    import torch.distributed as dist

    prepare()
    device = get_device()
    model = model.to(device)
    if dist.get_world_size() <= 1:
        return model
    from torch.nn.parallel import DistributedDataParallel

    if device.type == "cuda":
        return DistributedDataParallel(model, device_ids=[device.index])
    return DistributedDataParallel(model)


def prepare_data_loader(data_loader):
    """Re-build the DataLoader with a DistributedSampler so each worker sees
    its shard (reference: `prepare_data_loader`, `train_loop_utils.py:369`)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    prepare()
    if dist.get_world_size() <= 1:
        return data_loader
    sampler = DistributedSampler(
        data_loader.dataset,
        num_replicas=dist.get_world_size(),
        rank=dist.get_rank(),
        shuffle=True,
    )
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=0,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
    )


def get_device():
    """This worker's card (`cuda:LOCAL_RANK` among those it sees), or the
    CPU on a worker that sees none. The reference's (`torch_trainer.py:128`)
    is always the CPU."""
    import torch

    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", int(_gang_env().get("LOCAL_RANK", "0")) % torch.cuda.device_count())
