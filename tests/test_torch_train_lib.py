"""The port's Train library (`ray_tpu_torch.train`), after
`tests/test_train.py`: report, context and the gang's host collective,
checkpoints, restart from a checkpoint, `max_failures`, a start failure,
the `CheckpointManager` cases, in local and cluster mode (one runtime per
mode for the module); a `Checkpoint.from_pytree` round trip of f32 and bf16
tensors; and, in cluster mode:

* `prepare_model` (DDP) and `prepare_data_loader` on a gloo gang of 2
  (`tests/test_torch_trainer.py`'s cases);
* a `TorchTrainer` whose gloo gang of 2 CPU workers runs the tiny GPT step
  through `torch_utils.get_mesh()`: its losses over 3 f32 steps equal the
  reference's `make_train_step` (optax AdamW) on the same numpy params and
  batches within 1e-4 relative;
* the GPU-worker plumbing with a faked `GPU` resource: `use_gpu=True` puts
  the worker on the GPU kind (given the card), and `get_mesh()` raises
  there without one;
* the gang check (`train/gang_check.py`) at 8 gloo ranks against one rank
  (`tests/test_multihost_gang.py:51`).

A loop runs in the gang's workers, which cannot import this module: each
is a closure made by a factory, so cloudpickle ships it by value."""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    DataParallelTrainer,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)


@pytest.fixture(scope="module", params=["local", "cluster"])
def mode(request):
    if request.param == "local":
        rt.init(local_mode=True)
    else:
        rt.init(num_cpus=4, num_gpus=1)  # one advertised GPU, no card
    try:
        yield request.param
    finally:
        rt.shutdown()


def _fit(loop, tmp_path, workers=1, config=None, trainer=DataParallelTrainer, **run):
    return trainer(
        loop,
        train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers),
        run_config=RunConfig(storage_path=str(tmp_path), **run),
    ).fit()


def _report_loop():
    def loop(config):
        from ray_tpu_torch import train

        for i in range(3):
            train.report({"step": i, "loss": 1.0 / (i + 1)})

    return loop


def test_single_worker_report(mode, tmp_path):
    result = _fit(_report_loop(), tmp_path)
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3


def _collective_loop():
    def loop(config):
        import numpy as np

        from ray_tpu_torch import collective, train

        ctx = train.get_context()
        out = collective.allreduce(np.array([float(ctx.get_world_rank())]), group_name=config["collective_group"])
        train.report({"rank": ctx.get_world_rank(), "sum": float(out[0]), "world": ctx.get_world_size()})

    return loop


def test_multi_worker_context_and_collective(mode, tmp_path):
    result = _fit(_collective_loop(), tmp_path, workers=2)
    assert result.error is None
    assert result.metrics["sum"] == 1.0  # 0 + 1
    assert result.metrics["world"] == 2


def _checkpoint_loop():
    def loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        for i in range(3):
            train.report({"step": i, "score": float(i)}, checkpoint=Checkpoint.from_dict({"step": i, "w": [i] * 3}))

    return loop


def test_checkpointing(mode, tmp_path):
    result = _fit(_checkpoint_loop(), tmp_path, checkpoint_config=train.CheckpointConfig(
        num_to_keep=2, checkpoint_score_attribute="score"))
    assert result.checkpoint is not None
    assert result.checkpoint.to_dict()["step"] == 2


def _failing_once_loop(marker):
    def loop(config):
        import os

        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for i in range(start, 4):
            if i == 2 and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError("injected failure")
            train.report({"step": i}, checkpoint=Checkpoint.from_dict({"step": i}))

    return loop


def test_failure_restart_resumes_from_checkpoint(mode, tmp_path):
    marker = str(tmp_path / "died_once")
    result = _fit(_failing_once_loop(marker), tmp_path, failure_config=FailureConfig(max_failures=1))
    assert result.error is None
    assert result.metrics["step"] == 3
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]  # resumed past step 1's checkpoint
    assert result.checkpoint.to_dict()["step"] == 3


def _always_failing_loop():
    def loop(config):
        raise ValueError("always fails")

    return loop


def test_error_surfaces_after_max_failures(mode, tmp_path):
    result = _fit(_always_failing_loop(), tmp_path)
    assert result.error is not None and "always fails" in result.error


def test_start_failure_raises_deterministic_error(mode, tmp_path):
    from ray_tpu_torch.train.backend_executor import Backend

    class BrokenBackend(Backend):
        def on_start(self, worker_group, scaling):
            raise ValueError("bad backend config")

    trainer = DataParallelTrainer(lambda config: None, backend=BrokenBackend(),
                                  scaling_config=ScalingConfig(num_workers=1),
                                  run_config=RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(ValueError, match="bad backend config"):
        trainer.fit()


# ------------------------------------------------------------ checkpoints
class TestCheckpointManager:
    @staticmethod
    def _mgr(tmp_path, **kw):
        from ray_tpu_torch.train.checkpoint import CheckpointManager

        return CheckpointManager(str(tmp_path / "managed"), **kw)

    def test_register_is_crash_safe(self, tmp_path):
        from ray_tpu_torch.train.checkpoint import MANAGER_COMMIT_MARKER

        dest = self._mgr(tmp_path).register(Checkpoint.from_dict({"step": 1}), {"step": 1})
        assert os.path.exists(os.path.join(dest, MANAGER_COMMIT_MARKER))
        assert not os.path.exists(dest + ".tmp")
        assert Checkpoint(dest).to_dict()["step"] == 1

    @pytest.mark.parametrize("order", ["max", "min"])
    def test_topk_eviction_tie_keeps_newest(self, tmp_path, order):
        mgr = self._mgr(tmp_path, num_to_keep=2, score_attribute="score", score_order=order)
        paths = [mgr.register(Checkpoint.from_dict({"v": i}), {"score": 1.0}) for i in range(3)]
        assert not os.path.exists(paths[0])
        assert os.path.exists(paths[1]) and os.path.exists(paths[2])
        assert mgr.latest().path == paths[2] and mgr.best().path == paths[2]

    def test_adopted_entry_never_evicts_latest_own(self, tmp_path):
        kw = dict(num_to_keep=1, score_attribute="score", score_order="max")
        adopted = self._mgr(tmp_path, **kw).register(Checkpoint.from_dict({"v": 1}), {"score": 0.9})
        mgr2 = self._mgr(tmp_path, **kw)
        own = mgr2.register(Checkpoint.from_dict({"v": 2}), {"score": 0.5})
        assert os.path.exists(own) and not os.path.exists(adopted)
        assert mgr2.latest().path == own

    def test_resume_latest_skips_uncommitted(self, tmp_path):
        import shutil

        from ray_tpu_torch.train.checkpoint import MANAGER_COMMIT_MARKER, resume_latest

        mgr = self._mgr(tmp_path)
        mgr.register(Checkpoint.from_dict({"step": 1}), {"step": 1})
        p2 = mgr.register(Checkpoint.from_dict({"step": 2}), {"step": 2})
        crashed = os.path.join(mgr.directory, "checkpoint_000003")
        shutil.copytree(p2, crashed)
        os.remove(os.path.join(crashed, MANAGER_COMMIT_MARKER))
        os.makedirs(os.path.join(mgr.directory, "checkpoint_000004.tmp"))
        assert resume_latest(mgr.directory).path == p2
        assert resume_latest(str(tmp_path / "missing")) is None

    def test_fresh_manager_adopts_numbering_and_enforces_num_to_keep(self, tmp_path):
        from ray_tpu_torch.train.checkpoint import resume_latest

        mgr = self._mgr(tmp_path, num_to_keep=2)
        p1 = mgr.register(Checkpoint.from_dict({"step": 1}), {})
        p2 = mgr.register(Checkpoint.from_dict({"step": 2}), {})
        mgr2 = self._mgr(tmp_path, num_to_keep=2)
        p3 = mgr2.register(Checkpoint.from_dict({"step": 3}), {})
        assert p3.endswith("checkpoint_000003")
        assert not os.path.exists(p1) and os.path.exists(p2)
        assert mgr2.latest().path == p3 and resume_latest(mgr2.directory).to_dict()["step"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_pytree_round_trip(tmp_path, dtype):
    """Tensors save with torch.save on the CPU and load back bit for bit
    in their own dtype; a template puts them on its leaves' devices."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 3, generator=g).to(dtype), "opt": {"mu": torch.randn(5, generator=g).to(dtype),
                                                                  "step": 7}, "ids": [torch.arange(3)]}
    ckpt = Checkpoint.from_pytree(tree, str(tmp_path / "ck"))
    back = ckpt.to_pytree()
    assert back["w"].dtype == dtype and torch.equal(back["w"], tree["w"])
    assert torch.equal(back["opt"]["mu"], tree["opt"]["mu"]) and back["opt"]["step"] == 7
    assert torch.equal(back["ids"][0], tree["ids"][0])
    like = ckpt.to_pytree(template=tree)
    assert like["w"].device == tree["w"].device and torch.equal(like["w"], tree["w"])


# ------------------------------------------------------------ TorchTrainer
TINY = dict(vocab_size=64, n_layers=2, d_model=32, n_heads=2, d_head=16, d_mlp=64, max_seq=16,
            attn_impl="ref", remat=False)
LR = 1e-2
HYPER = dict(weight_decay=0.1, eps=1e-3)


def _np_params():
    from ray_tpu_torch.models import gpt as tg

    shapes = {k: tuple(v.shape) for k, v in tg.init_params(tg.GPTConfig(**TINY, dtype=torch.float32),
                                                           device="cpu").items()}
    rng = np.random.default_rng(0)
    return {k: (1 + 0.1 * rng.standard_normal(s) if k.endswith("_w") else 0.3 * rng.standard_normal(s))
            .astype(np.float32) for k, s in shapes.items()}


def _gpt_gang_loop():
    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.optim import AdamW
        from ray_tpu_torch.parallel import place
        from ray_tpu_torch.train import torch as tt

        torch.set_num_threads(1)
        mesh = tt.torch_utils.get_mesh(device_type="cpu")
        cfg = gpt.GPTConfig(**config["cfg"], dtype=torch.float32)
        shardings = gpt.param_shardings(cfg, mesh)
        params = {k: place(v, mesh, shardings[k]).detach()
                  for k, v in params_from_jax(config["params"], cfg, device="cpu").items()}
        step = gpt.make_train_step(cfg, AdamW(params.values(), lr=config["lr"], mu_dtype=torch.bfloat16,
                                              **config["hyper"]), mesh=mesh)
        for i, tokens in enumerate(config["tokens"]):
            _, m = step(params, {"tokens": torch.as_tensor(tokens)})
            train.report({"step": i, "loss": m["loss"].item(), "backend": dist.get_backend(),
                          "world": dist.get_world_size(), "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                          "device": str(tt.get_device())})

    return loop


@pytest.mark.parametrize("mode", ["cluster"], indirect=True)  # a gang of processes
def test_torch_trainer_gloo_gang_trains_the_gpt_step_as_the_reference(mode, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt as jg

    params = _np_params()
    rng = np.random.default_rng(1)
    tokens = [rng.integers(0, TINY["vocab_size"], (4, 17)) for _ in range(3)]
    result = _fit(_gpt_gang_loop(), tmp_path, workers=2, trainer=TorchTrainer,
                  config={"cfg": TINY, "params": params, "tokens": tokens, "lr": LR, "hyper": HYPER})
    assert result.error is None, result.error
    got = [m["loss"] for m in result.metrics_history]
    last = result.metrics_history[-1]
    assert last["backend"] == "gloo" and last["world"] == 2 and last["device"] == "cpu"
    assert {k: int(v) for k, v in last["mesh"].items()} == {"dp": 2}

    cfg = jg.GPTConfig(**TINY, dtype=jnp.float32)
    opt = optax.adamw(LR, mu_dtype=jnp.bfloat16, **HYPER)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state, step = (jparams, opt.init(jparams)), jax.jit(jg.make_train_step(cfg, opt))
    want = []
    for t in tokens:
        state, m = step(state, {"tokens": jnp.asarray(t, jnp.int32)})
        want.append(float(m["loss"]))
    assert got == pytest.approx(want, rel=1e-4)


def _ddp_loop():
    def loop(config):
        import torch
        import torch.nn as nn
        from torch.utils.data import DataLoader, TensorDataset

        from ray_tpu_torch import train
        from ray_tpu_torch.train import torch as tt

        torch.set_num_threads(1)
        torch.manual_seed(0)  # identical init on every worker
        model = tt.prepare_model(nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        rank = train.get_context().get_world_rank()
        X = torch.randn(64, 4, generator=torch.Generator().manual_seed(100 + rank))
        y = X @ torch.tensor([[1.0, -2.0, 3.0, 0.5]]).T
        losses = []
        for _ in range(30):
            opt.zero_grad()
            loss = nn.functional.mse_loss(model(X), y)
            loss.backward()  # DDP allreduces the gradients here
            opt.step()
            losses.append(loss.item())
        seen = sum(len(b[0]) for b in tt.prepare_data_loader(
            DataLoader(TensorDataset(torch.arange(32).float()), batch_size=4)))
        train.report({"first_loss": losses[0], "last_loss": losses[-1], "seen": seen, "ddp": type(model).__name__})

    return loop


@pytest.mark.parametrize("mode", ["cluster"], indirect=True)  # a gang of processes
def test_prepare_model_ddp_converges_and_data_loader_shards(mode, tmp_path):
    """`tests/test_torch_trainer.py`'s cases on the port: 2-worker DDP over
    gloo on a toy regression converges, and a DistributedSampler gives each
    worker half of the rows."""
    result = _fit(_ddp_loop(), tmp_path, workers=2, trainer=TorchTrainer)
    assert result.error is None, result.error
    m = result.metrics
    assert m["ddp"] == "DistributedDataParallel"
    assert m["last_loss"] < m["first_loss"] * 0.2
    assert m["seen"] == 16  # 32 rows over 2 workers


def _gpu_probe_loop():
    def loop(config):
        import os

        from ray_tpu_torch import train
        from ray_tpu_torch.train import torch as tt

        try:
            tt.torch_utils.get_mesh()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        cpu_mesh = tt.torch_utils.get_mesh(device_type="cpu")
        train.report({"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "accelerator_worker": os.environ.get("RAY_TPU_WORKER_TPU"),
                      "raised": raised, "cpu_mesh": cpu_mesh.device_type, "device": str(tt.get_device())})

    return loop


@pytest.mark.parametrize("mode", ["cluster"], indirect=True)  # worker kinds are processes
def test_use_gpu_places_the_worker_on_the_gpu_kind(mode, tmp_path):
    assert rt.cluster_resources().get("GPU") == 1.0
    assert ScalingConfig(use_gpu=True).worker_resources() == {"GPU": 1.0, "CPU": 1.0}
    result = TorchTrainer(_gpu_probe_loop(), scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                          run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    m = result.metrics
    assert m["cuda_visible_devices"] == "0" and m["accelerator_worker"] == "1"
    assert "no CUDA device" in m["raised"]
    assert m["cpu_mesh"] == "cpu" and m["device"] == "cpu"


def test_gang_check_at_eight_ranks_equals_one_rank():
    from ray_tpu_torch.train.gang_check import spawn_gang

    one = spawn_gang(nprocs=1)[0]
    outs = spawn_gang(nprocs=8)
    for o in outs:
        assert o["n_global"] == 8.0 and o["n_local"] == 1.0
        assert o["psum"] == 28.0  # sum(range(8)): every process's shard
        assert o["loss"] == pytest.approx(one["loss"], rel=1e-5)
        assert o["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-4)
    assert one["psum"] == 0.0 and one["loss"] > 0
