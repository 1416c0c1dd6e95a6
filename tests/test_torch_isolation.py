"""The port stands alone: no module of `ray_tpu_torch/`, and not
`chip_smoke.py`, imports `jax` or anything of the JAX package `ray_tpu`,
or names a module of `ray_tpu` in a string (a `-m` path boots the
reference's processes); importing the port loads neither; and its entry
points refuse to run without a card unless the caller asks for the CPU.

The runtime, Serve, Train's core and the data plane are a copy of the
reference's (`RUNTIME_COPY`): each copied file equals its reference after
the import rewrite (`rewrite`), except the files in `DIVERGES`, where every
changed line sits next to a comment that names the reference line it
replaces. The engine and the other `PORTS` are ports, not copies: each
keeps the reference's classes, functions and methods, in order (and the
engine the order of the calls its `step()` makes)."""

import ast
import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# ml_dtypes comes with JAX here but not on the card's machine: numpy has no
# bf16 there, so the port carries bf16 as tagged uint16 bits.
FORBIDDEN = ("jax", "jaxlib", "ray_tpu", "ml_dtypes")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# A string that names a module of the reference (`ray_tpu.core.worker_main`),
# a `-m` launch of one (`-m ray_tpu...`) or its session root (`/tmp/ray_tpu`),
# never the port's `ray_tpu_torch`. (File paths such as `ray_tpu/ops/...` in
# docstrings name the code a port is held against, and are no module path.)
REFERENCE_PATH = re.compile(r"\bray_tpu\.\w|-m\s+ray_tpu\b|/tmp/ray_tpu\b")


def _strings(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value


# The generated protobuf modules stay byte-identical to the reference's (two
# copies then share one descriptor pool entry): their names are the wire's.
STRING_FILES = [p for p in PORT_FILES if not p.name.endswith("_pb2.py")]


@pytest.mark.parametrize("path", STRING_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_reference_module(path):
    bad = [(line, s[:80]) for line, s in _strings(path) if REFERENCE_PATH.search(s)]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_reference_path_pattern():
    hits = ["ray_tpu.core.worker_main", "-m ray_tpu", "-m  ray_tpu.core.forkserver", "/tmp/ray_tpu",
            "/tmp/ray_tpu/session_latest", "see ray_tpu.dag.compiled"]
    misses = ["ray_tpu_torch.core.worker_main", "-m ray_tpu_torch", "/tmp/ray_tpu_torch", "ray_tpu_pb2",
              "RAY_TPU_ADDRESS", "ray_tpu_torch_arena", "rtput-1-2", "ray_tpu/ops/attention.py:220"]
    assert all(REFERENCE_PATH.search(s) for s in hits)
    assert not any(REFERENCE_PATH.search(s) for s in misses)


# ------------------------------------------------------------ runtime copy
REF = ROOT / "ray_tpu"
PORT = ROOT / "ray_tpu_torch"
RUNTIME_COPY = (
    "core", "native/__init__.py", "native/src/arena.cpp", "native/src/channel.cpp",
    "native/src/bulk.cpp", "protocol", "dag", "experimental", "runtime_env", "dashboard",
    "cluster_utils.py", "_version.py", "util/__init__.py", "util/metrics.py", "util/tracing.py",
    "util/flight.py", "util/chaos.py", "util/placement_group.py", "util/actor_pool.py", "util/queue.py",
    "util/state.py", "util/system_metrics.py", "util/memory_monitor.py", "util/accelerators/__init__.py",
    "util/accelerators/accelerator.py",
    # Serve: the control plane, router, proxies, fleet policy, the KV
    # bookkeeping and transfer plane, the engine and its deployment.
    "serve/__init__.py", "serve/_common.py", "serve/context.py", "serve/batching.py", "serve/deployment.py",
    "serve/fleet", "serve/replica.py", "serve/handle.py", "serve/controller.py", "serve/api.py",
    "serve/http_proxy.py", "serve/grpc_proxy.py", "serve/engine/kv_transfer.py", "serve/engine/kv_manager.py",
    "serve/engine/scheduler.py", "serve/engine/kv_tier.py", "serve/engine/spec.py", "serve/engine/deployment.py",
    "serve/engine/engine.py",
    # The host-plane collective groups over the object store (the in-program
    # collectives beside them, `collective/ops.py`, are a port).
    "collective/__init__.py",
    # The in-program GPipe pipeline (a port: PORTS).
    "parallel/pipeline.py",
    # Train: the trainer core, checkpoints and the elastic layer, the
    # trainer (the port of two reference files) and the gang check.
    "train/config.py", "train/result.py", "train/session.py", "train/base_trainer.py",
    "train/data_parallel_trainer.py", "train/worker_group.py", "train/backend_executor.py",
    "train/checkpoint.py", "train/elastic", "train/torch_trainer.py", "train/gang_check.py",
    # MPMD pipeline training: the schedule copied, the rest ported.
    "train/mpmd",
    # The data plane, streaming ingest included.
    "data",
    # HF GPT-2 interop (a port: PORTS).
    "train/huggingface.py",
    # The GBDT booster (a port: PORTS) and its trainers.
    "models/gbdt.py", "train/gbdt_trainer.py",
    # RLlib's core, PPO and multi-agent PPO: the envs, connectors, offline
    # data and replay buffers copied; the modules, catalog, learner,
    # optimizer, GAE, runners and PPO ported (PORTS).
    "rllib/__init__.py", "rllib/env", "rllib/connectors", "rllib/utils", "rllib/offline", "rllib/core",
    "rllib/algorithms/__init__.py", "rllib/algorithms/algorithm_config.py", "rllib/algorithms/algorithm.py",
    "rllib/algorithms/ppo.py", "rllib/algorithms/multi_agent_ppo.py",
    # RLlib's discrete-action algorithms (ports: PORTS).
    "rllib/algorithms/a2c.py", "rllib/algorithms/impala.py", "rllib/algorithms/appo.py",
    "rllib/algorithms/dqn.py", "rllib/algorithms/apex_dqn.py", "rllib/algorithms/bc.py",
    "rllib/algorithms/marwil.py", "rllib/algorithms/cql.py",
    # RLlib's continuous-control algorithms and the Decision Transformer
    # (ports: PORTS; DDPG, TD3 with other settings, a copy).
    "rllib/algorithms/sac.py", "rllib/algorithms/td3.py", "rllib/algorithms/ddpg.py",
    "rllib/algorithms/dt.py",
    # DreamerV3 (a port: PORTS; its fragment replay copied line for line,
    # tests/test_torch_rllib_dreamer.py).
    "rllib/algorithms/dreamerv3.py",
    # The podracer planes: the trajectory transport copied, the torch env
    # forms, Anakin and Sebulba ported (PORTS).
    "rllib/podracer",
    # Tune, durable workflows and the host tools: the ops CLI, job
    # submission, the multiprocessing Pool and the joblib backend.
    "tune/search_space.py", "tune/schedulers.py", "tune/search.py", "tune/tuner.py", "tune/__init__.py",
    "workflow/storage.py", "workflow/executor.py", "workflow/event_listener.py", "workflow/__init__.py",
    "scripts/__init__.py", "scripts/cli.py", "job_submission.py", "util/multiprocessing.py", "util/joblib.py",
    # The autoscaler: load metrics, the demand packer, the node providers
    # (the fake multi-node one, KubeRay's and TPU-VM's with their in-memory
    # doubles), the update loop and request_resources.
    "autoscaler",
)
# Files the port names otherwise: its path -> the reference's.
RENAMED = {"rllib/podracer/torch_env.py": "rllib/podracer/jax_env.py"}
# Port-only files inside the copied directories.
PORT_ONLY = {"core/devices.py", "core/host_names.py", "rllib/utils/tree.py"}
# Copied files that diverge from the reference, and why.
DIVERGES = {
    "core/api.py": "init(num_gpus=...) sets the GPU resource",
    "core/controller.py": "GPU worker kind: resource key, device pinning, GPU lease spawns; GPU workers forked "
                          "from the template too; the lease backlog holds the submitter's waiting tasks, and "
                          "a parked lease spawns on a node that joins",
    "core/direct.py": "GPU worker kind: resource key of a lease; a lease request names its waiting tasks",
    "core/node_agent.py": "GPU worker kind: device pinning; GPU workers forked from the template too",
    "core/forkserver.py": "template pre-imports torch, no card; reports its state; GPU workers fork from it too",
    "core/exceptions.py": "an error that crossed two tasks unpickles",
    "core/cluster_backend.py": "session root under TMPDIR (host_names.SESSION_ROOT)",
    "core/rpc.py": "session root under TMPDIR (host_names.SESSION_ROOT)",
    "core/runtime.py": "session root under TMPDIR (host_names.SESSION_ROOT)",
    "core/worker_main.py": "session root under TMPDIR (host_names.SESSION_ROOT)",
    "core/store.py": "session root under TMPDIR, shm prefix rtput- (host_names)",
    "cluster_utils.py": "session root under TMPDIR (host_names.SESSION_ROOT)",
    "native/__init__.py": "library names",
    "util/accelerators/__init__.py": "no TPU manager",
    "util/accelerators/accelerator.py": "the NVIDIA GPU manager first, nvidia-smi detection",
    "util/system_metrics.py": "card memory in use from torch, not JAX",
    "serve/engine/kv_manager.py": "docstring: two lines without the reference's own history",
    "serve/engine/kv_transfer.py": "docstring and a comment without the reference's own history",
    "serve/fleet/autoscale.py": "docstring: a line without the reference's own history",
    "collective/__init__.py": "docstring: a line without the reference's own history",
    "serve/engine/deployment.py": "dtype by device.resolve_dtype, a device argument",
    "serve/engine/engine.py": "the engine on torch tensors: a port (PORTS)",
    "train/config.py": "ScalingConfig.use_gpu and the GPU resource key, where the reference has use_tpu / TPU",
    "train/worker_group.py": "the worker bundle's GPU key and num_gpus= (core/devices.ACCELERATOR)",
    "train/checkpoint.py": "pytrees saved with torch.save, tensors on the CPU in their own dtype; no orbax",
    "train/elastic/ckpt.py": "torch's pytrees and CPU torch tensors (bf16 kept), not jax.tree_util and numpy",
    "parallel/pipeline.py": "the GPipe tick loop in eager torch: a port (PORTS)",
    "train/gang_check.py": "one torch.distributed world, not jax.distributed: a port (PORTS)",
    "train/torch_trainer.py": "the port of train/jax_trainer.py and train/torch_trainer.py (PORTS)",
    "train/mpmd/__init__.py": "docstring: the port's stage programs, workers and wire (PORTS)",
    "train/mpmd/zero.py": "the flat master, m and v as torch tensors on the runner's device, the "
                          "update in torch ops (PORTS)",
    "train/mpmd/stage.py": "eager torch stage programs on a device, in-place accumulation, launches per "
                           "step (PORTS)",
    "train/mpmd/local.py": "torch params seeded on the CPU, a device argument (PORTS)",
    "train/mpmd/transport.py": "tensors cross as numpy with a dtype tag (bf16 as uint16 bits); bf16 wire "
                               "cast by torch, not ml_dtypes",
    "train/mpmd/trainer.py": "GPU-worker stage actors (num_gpus_per_replica), a device option, params "
                             "seeded in torch, per-replica metrics",
    "data/__init__.py": "docstring: the torch feed; pandas imported eagerly only where it is installed",
    "data/block.py": "docstring: blocks feed torch.as_tensor, not jax.device_put",
    "data/iterator.py": "iter_jax_batches dropped (it imports jax); docstring names the torch feed",
    "data/dataset.py": "Dataset.iter_jax_batches dropped with the iterator's",
    "data/README.md": "the torch feed in place of the JAX one",
    "train/huggingface.py": "the loop on the port's step and AdamW on the card; params through the object "
                            "store: fit() puts config['init_params'] there and a loop gets them by ref; "
                            "TransformersTrainer over TorchTrainer (PORTS)",
    "models/gbdt.py": "the booster on torch tensors on a device, a deterministic scatter-add (PORTS)",
    "train/gbdt_trainer.py": "a GPU worker by default; the loop fits on the worker's device; docstrings name "
                             "the torch booster",
    "rllib/__init__.py": "exports connectors beside what the reference exports; docstring names the "
                         "torch learner and runners and the port's podracer planes",
    "rllib/utils/optim.py": "a functional optimizer with optax's semantics in torch (PORTS)",
    "rllib/utils/gae.py": "the reverse scan as a loop over T in torch (PORTS)",
    "rllib/core/catalog.py": "encoders in torch: F.conv2d on NCHW with HWIO kernels, the LSTM scan as a loop "
                             "(PORTS)",
    "rllib/core/rl_module.py": "modules over trees of torch tensors, torch.Generator sampling, params_from_numpy "
                               "(PORTS)",
    "rllib/core/learner.py": "the update eager on a device with a torch.Generator; a GPU-worker learner actor; "
                             "mesh= raises (PORTS)",
    "rllib/env/env_runner.py": "the forward in torch on the runner's device, torch.Generator sampling (PORTS)",
    "rllib/env/ma_runner.py": "per-policy forwards in torch on the runner's device (PORTS)",
    "rllib/algorithms/algorithm_config.py": "a device field set by resources(device=); Anakin checks for a "
                                            "TorchEnv form (torch_env_registered)",
    "rllib/algorithms/algorithm.py": "the learner and local runner on config.device, remote runners CPU actors "
                                     "on the CPU",
    "rllib/algorithms/ppo.py": "the update eager in torch, split into permutations and the update given them; "
                               "axis_name= (a pmean across cards) raises (PORTS)",
    "rllib/algorithms/multi_agent_ppo.py": "the learners and runners on config.device",
    "rllib/offline/__init__.py": "OfflineDataset carries rewards, next_obs and dones, and collect_dataset "
                                 "records them with transitions=True (the reference's CQL reads them, its "
                                 "dataset has none)",
    "rllib/algorithms/a2c.py": "the update in torch on the learner's device, one CUDA graph on the card (PORTS)",
    "rllib/algorithms/impala.py": "the V-trace update in torch, the reverse scan a loop over T, one CUDA graph on "
                                  "the card (PORTS)",
    "rllib/algorithms/appo.py": "the clipped surrogate on IMPALA's V-trace, in torch, one CUDA graph on the card "
                                "(PORTS)",
    "rllib/algorithms/dqn.py": "QPolicyModule over torch tensors with torch.Generator epsilon-greedy; the "
                               "minibatch scan a loop, each step a CUDA graph on the card (PORTS)",
    "rllib/algorithms/apex_dqn.py": "the TD errors for new priorities in torch on the learner's device (PORTS)",
    "rllib/algorithms/bc.py": "the update split into permutations and the update given them (PORTS)",
    "rllib/algorithms/marwil.py": "the loss in torch over BC's update (PORTS)",
    "rllib/algorithms/cql.py": "the update split into permutations and the update given them (PORTS)",
    "rllib/algorithms/sac.py": "the update's normal draws taken apart from it (update.with_draws), "
                               "sample_action given its draw; each gradient step a CUDA graph on the card "
                               "(PORTS)",
    "rllib/algorithms/td3.py": "the target-policy noise drawn apart from the update (update.with_draws); the "
                               "policy-delay cond a host branch; each gradient step a CUDA graph on the card "
                               "(PORTS)",
    "rllib/algorithms/dreamerv3.py": "every categorical draw a Gumbel argmax given its noise, drawn apart: "
                                     "act from the runner's generator (act_with_draws), the update's from "
                                     "the learner's (update.with_draws); the two scans loops; critic_t "
                                     "starts as critic's copy; percentile as JAX's sort and interpolation; "
                                     "each gradient step a CUDA graph on the card (PORTS)",
    "rllib/algorithms/dt.py": "the port's _block (no mesh, a 4-tuple) looped over layers and "
                              "init_params(cfg, seed); the time embedding clamped, its out-of-range rows "
                              "without gradient, as JAX's gather; evaluation on the learner's device (PORTS)",
    "rllib/podracer/__init__.py": "the torch env forms' names (TorchEnv, make_torch_env, ...)",
    "rllib/podracer/torch_env.py": "the jax_env forms in torch; reset_fn maps reset uniforms handed in, no key "
                                   "(PORTS)",
    "rllib/podracer/anakin.py": "the rollout one CUDA graph on the card, its draws (Gumbel or normal action "
                                "noise, reset uniforms) and the update's permutations taken apart from it "
                                "(with_draws); one device, more raise (PORTS)",
    "rllib/podracer/sebulba.py": "CPU-actor EnvRunners; the learner's torch update on its device, a GPU worker "
                                 "on the card; a state blob of CPU tensors and the generator's state (PORTS)",
    "tune/tuner.py": "a trial's GPU share is placed with num_gpus= (the reference places its TPU share with "
                     "num_tpus=)",
    "workflow/storage.py": "the default root under TMPDIR, beside the sessions (host_names.SESSION_ROOT)",
    "workflow/__init__.py": "docstring: init()'s default root under TMPDIR",
    "scripts/cli.py": "session_latest under TMPDIR (host_names.SESSION_ROOT): the address, its error text, the "
                      "docstring",
    "job_submission.py": "session_latest under TMPDIR (host_names.SESSION_ROOT)",
    "autoscaler/resource_demand_scheduler.py": "GPU demand packs first and GPU node types sort last (the "
                                               "reference weighs its own accelerator key, TPU)",
}
# Diverging files that are ports, held by their structure, not line by line:
# a class (its methods in the reference's order, its step()'s calls in
# order), or a module (its top-level functions and classes in the
# reference's order, and each class's methods in theirs) ported from one
# reference file or several, with the names the port gives them.
PORTS = {
    "serve/engine/engine.py": {"class": "InferenceEngine"},
    "parallel/pipeline.py": {"module": ["parallel/pipeline.py"]},
    "train/gang_check.py": {"module": ["train/gang_check.py"]},
    # One trainer for the reference's two: the accelerator trainer (one JAX
    # worker per host) and the CPU gloo trainer.
    "train/torch_trainer.py": {"module": ["train/jax_trainer.py", "train/torch_trainer.py"],
                               "renames": {"JaxBackend": "TorchBackend", "JaxTrainer": "TorchTrainer",
                                           "jax_utils": "torch_utils"}},
    "train/mpmd/__init__.py": {"module": ["train/mpmd/__init__.py"]},
    # The jitted update is the torch update (`_adamw`).
    "train/mpmd/zero.py": {"module": ["train/mpmd/zero.py"], "renames": {"_adamw_jit": "_adamw"}},
    "train/mpmd/stage.py": {"module": ["train/mpmd/stage.py"]},
    "train/mpmd/local.py": {"module": ["train/mpmd/local.py"]},
    "train/huggingface.py": {"module": ["train/huggingface.py"]},
    "models/gbdt.py": {"module": ["models/gbdt.py"]},
    "rllib/utils/optim.py": {"module": ["rllib/utils/optim.py"]},
    "rllib/utils/gae.py": {"module": ["rllib/utils/gae.py"]},
    "rllib/core/catalog.py": {"module": ["rllib/core/catalog.py"]},
    "rllib/core/rl_module.py": {"module": ["rllib/core/rl_module.py"]},
    "rllib/core/learner.py": {"module": ["rllib/core/learner.py"]},
    "rllib/env/env_runner.py": {"module": ["rllib/env/env_runner.py"]},
    "rllib/env/ma_runner.py": {"module": ["rllib/env/ma_runner.py"]},
    "rllib/algorithms/ppo.py": {"module": ["rllib/algorithms/ppo.py"]},
    **{f"rllib/algorithms/{name}.py": {"module": [f"rllib/algorithms/{name}.py"]}
       for name in ("a2c", "impala", "appo", "dqn", "apex_dqn", "bc", "marwil", "cql", "sac", "td3", "dt",
                    "dreamerv3")},
    "rllib/podracer/anakin.py": {"module": ["rllib/podracer/anakin.py"]},
    "rllib/podracer/sebulba.py": {"module": ["rllib/podracer/sebulba.py"]},
    "rllib/podracer/torch_env.py": {"module": ["rllib/podracer/jax_env.py"],
                                    "renames": {"JaxEnv": "TorchEnv", "JaxCartPole": "TorchCartPole",
                                                "JaxPendulum": "TorchPendulum",
                                                "register_jax_env": "register_torch_env",
                                                "make_jax_env": "make_torch_env",
                                                "jax_env_registered": "torch_env_registered"}},
}


def rewrite(text: str) -> str:
    """The reference's text with its own name replaced by the port's:
    imports and module paths in strings. (The session root and the shm
    prefix are no rewrite: the port's follow TMPDIR and differ, `DIVERGES`.)"""
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


def _copied():
    out = []
    port_name = {ref: port for port, ref in RENAMED.items()}
    for entry in RUNTIME_COPY:
        ref = REF / entry
        files = sorted(f for f in ref.rglob("*") if f.is_file()) if ref.is_dir() else [ref]
        rels = [f.relative_to(REF).as_posix() for f in files
                if "__pycache__" not in f.parts and "_build" not in f.parts]
        out += [port_name.get(rel, rel) for rel in rels]
    return out


COPIED = _copied()


def test_every_runtime_file_is_copied_and_nothing_else_is_there():
    assert len(COPIED) > 60
    on_disk = set()
    for entry in RUNTIME_COPY:
        port = PORT / entry
        files = sorted(f for f in port.rglob("*") if f.is_file()) if port.is_dir() else [port]
        on_disk |= {f.relative_to(PORT).as_posix() for f in files
                    if "__pycache__" not in f.parts and "_build" not in f.parts}
    assert on_disk - PORT_ONLY == set(COPIED)
    assert set(DIVERGES) <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_does_not_drift(rel):
    ref, port = (REF / RENAMED.get(rel, rel)).read_bytes(), (PORT / rel).read_bytes()
    if rel.endswith("_pb2.py") or rel.endswith(".proto"):
        assert port == ref, "generated protobuf and its source stay byte-identical"
        return
    if rel in PORTS:
        spec = PORTS[rel]
        if "class" in spec:
            _assert_same_structure(ref.decode(), port.decode(), spec["class"])
        for src in spec.get("module", ()):
            _assert_same_module((REF / src).read_text(), port.decode(), spec.get("renames", {}))
        return
    want = rewrite(ref.decode()).splitlines()
    got = port.decode().splitlines()
    if rel not in DIVERGES:
        assert got == want, f"{rel} drifted from ray_tpu/{rel}: add it to DIVERGES or re-copy it"
        return
    assert got != want, f"{rel} no longer diverges: take it off DIVERGES"
    for j1, j2 in _changed_regions(want, got):
        near = got[max(0, j1 - 3):j2 + 3]
        assert any("reference" in line for line in near), \
            f"{rel}:{j1 + 1}: a change without a comment naming the reference line: {got[j1:j2]}"


def _methods(tree, cls: str) -> dict:
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls)
    return {f.name: f for f in node.body if isinstance(f, ast.FunctionDef)}


def _self_calls(fn) -> list:
    """The `self.<name>(...)` calls of a function, in source order."""
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and isinstance(n.func.value, ast.Name) and n.func.value.id == "self"]
    return [c.func.attr for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset))]


def _assert_same_structure(ref: str, port: str, cls: str):
    """A ported class keeps every method of the reference's, in the
    reference's order (the port may add helpers), and each step of its
    `step()` in the same order."""
    want, got = _methods(ast.parse(ref), cls), _methods(ast.parse(port), cls)
    missing = [m for m in want if m not in got]
    assert not missing, f"{cls}: methods of the reference not ported: {missing}"
    assert [m for m in got if m in want] == list(want), f"{cls}: methods out of the reference's order"
    assert _self_calls(got["step"]) == _self_calls(want["step"]), f"{cls}.step() calls differ"


def test_structure_check_catches_a_missing_method_and_a_reordered_step():
    ref = "class E:\n    def a(self): pass\n    def step(self):\n        self.a()\n        self.b()\n"
    _assert_same_structure(ref, ref.replace("def a(self): pass", "def a(self): pass\n    def c(self): pass"), "E")
    with pytest.raises(AssertionError, match="not ported"):
        _assert_same_structure(ref, ref.replace("def a(self): pass", "def z(self): pass"), "E")
    with pytest.raises(AssertionError, match="calls differ"):
        _assert_same_structure(ref, ref.replace("self.a()\n        self.b()", "self.b()\n        self.a()"), "E")


def _top_level(tree) -> dict:
    return {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def _assert_same_module(ref: str, port: str, renames: dict):
    """A ported module keeps every top-level function and class of the
    reference's (renamed as given), in the reference's order, and each
    class every method of the reference's class, in order (the port may add
    helpers)."""
    want = {renames.get(k, k): n for k, n in _top_level(ast.parse(ref)).items()}
    got = _top_level(ast.parse(port))
    missing = [k for k in want if k not in got]
    assert not missing, f"functions and classes of the reference not ported: {missing}"
    assert [k for k in got if k in want] == list(want), "functions and classes out of the reference's order"
    for name, node in want.items():
        if isinstance(node, ast.ClassDef):
            methods = [f.name for f in node.body if isinstance(f, ast.FunctionDef)]
            have = [f.name for f in got[name].body if isinstance(f, ast.FunctionDef)]
            assert [m for m in have if m in methods] == methods, f"{name}: methods {methods}, port has {have}"


def test_module_structure_check_catches_a_missing_or_moved_function():
    ref = "def a(): pass\nclass B:\n    def m(self): pass\n    def n(self): pass\ndef c(): pass\n"
    _assert_same_module(ref, ref.replace("def c(): pass", "def helper(): pass\ndef c(): pass"), {})
    _assert_same_module(ref, ref.replace("class B", "class Bee"), {"B": "Bee"})
    with pytest.raises(AssertionError, match="not ported"):
        _assert_same_module(ref, ref.replace("def c(): pass", ""), {})
    with pytest.raises(AssertionError, match="order"):
        _assert_same_module(ref, "def c(): pass\n" + ref.replace("def c(): pass", ""), {})
    with pytest.raises(AssertionError, match="methods"):
        _assert_same_module(ref, ref.replace("def n(self): pass", "pass"), {})


def _changed_regions(want: list, got: list, bridge: int = 4):
    """[j1, j2) line ranges of `got` that differ from `want`, with changes
    fewer than `bridge` equal lines apart merged into one region (a rewritten
    function is one change, however many of its lines happen to match)."""
    regions = []
    for tag, _, _, j1, j2 in difflib.SequenceMatcher(None, want, got, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        if regions and j1 - regions[-1][1] < bridge:
            regions[-1][1] = j2
        else:
            regions.append([j1, j2])
    return regions


# ------------------------------------------------------------ host names
def test_session_root_follows_tmpdir(monkeypatch):
    """Sessions live under TMPDIR (two checkouts with their own TMPDIR share
    no session_latest link and no auth token); a TMPDIR too deep for the
    forkserver's Unix socket gets a short root of its own under /tmp."""
    from ray_tpu_torch.core import host_names

    monkeypatch.setattr(host_names.tempfile, "gettempdir", lambda: "/scratch/a/tmp")
    assert host_names._session_root() == "/scratch/a/tmp/ray_tpu_torch"
    deep = [f"/scratch/{c * 60}/tmp" for c in "ab"]
    roots = []
    for d in deep:
        monkeypatch.setattr(host_names.tempfile, "gettempdir", lambda d=d: d)
        roots.append(host_names._session_root())
    assert roots[0] != roots[1] and all(r.startswith("/tmp/ray_tpu_torch-") for r in roots)
    longest = os.path.join(host_names.SESSION_ROOT, "cluster_1760000000000_4194304",
                           "forkserver-node99.sock.tmp")
    assert all(len(r) <= host_names._MAX_ROOT for r in roots) and len(longest.encode()) <= 107


@pytest.mark.parametrize("package,own", [("ray_tpu_torch", "rtput-"), ("ray_tpu", "rtpu-")])
def test_stale_segment_cleanup_sweeps_only_its_own_prefix(package, own, monkeypatch):
    """A controller's startup cleanup unlinks dead sessions' segments of its
    own package only: the port's never takes a (maybe restorable) segment of
    the reference's, nor the reference's one of the port's."""
    import importlib

    store = importlib.import_module(f"{package}.core.store")
    dead = "999999999"  # above any pid_max: no /proc entry, no restorable marker
    names = [f"rtput-{dead}-ab", f"rtpu-{dead}-cd", f"rtpu-{dead}-arena", f"rtput-{dead}-arena"]
    listdir, unlinked = os.listdir, []
    monkeypatch.setattr(os, "listdir", lambda d: list(names) if d == "/dev/shm" else listdir(d))
    monkeypatch.setattr(os, "unlink", lambda path: unlinked.append(path) if path.startswith("/dev/shm/")
                        else None)
    store.cleanup_stale_segments()
    assert sorted(unlinked) == sorted(f"/dev/shm/{n}" for n in names if n.startswith(own))


def test_importing_the_port_loads_neither_jax_nor_ray_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.serve.engine, ray_tpu_torch.kernels.build\n"
        "import ray_tpu_torch.kernels.flash_fwd, ray_tpu_torch.kernels.rmsnorm\n"
        "import ray_tpu_torch.kernels.flash_bwd, ray_tpu_torch.optim\n"
        "import ray_tpu_torch.core.api, ray_tpu_torch.dag, ray_tpu_torch.cluster_utils\n"
        "import ray_tpu_torch.core.controller, ray_tpu_torch.core.worker_main\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.engine.deployment, ray_tpu_torch.serve.fleet\n"
        "import ray_tpu_torch.serve.engine.kv_transfer, ray_tpu_torch.serve.http_proxy\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.spmd, ray_tpu_torch.collective\n"
        "import ray_tpu_torch.collective.ops, ray_tpu_torch.ops.moe\n"
        "import ray_tpu_torch.parallel.pipeline, ray_tpu_torch.train, ray_tpu_torch.train.elastic\n"
        "import ray_tpu_torch.train.gang_check, ray_tpu_torch.train.torch_trainer\n"
        "import ray_tpu_torch.train.mpmd, ray_tpu_torch.train.mpmd.trainer\n"
        "import ray_tpu_torch.data, ray_tpu_torch.data.streaming, ray_tpu_torch.train.huggingface\n"
        "import ray_tpu_torch.models.gbdt, ray_tpu_torch.train.gbdt_trainer, ray_tpu_torch.rllib\n"
        "import ray_tpu_torch.rllib.core, ray_tpu_torch.rllib.env.ma_runner, ray_tpu_torch.rllib.offline\n"
        "import ray_tpu_torch.rllib.algorithms.apex_dqn, ray_tpu_torch.rllib.algorithms.cql\n"
        "import ray_tpu_torch.rllib.algorithms.appo, ray_tpu_torch.rllib.algorithms.marwil\n"
        "import ray_tpu_torch.rllib.algorithms.sac, ray_tpu_torch.rllib.algorithms.td3\n"
        "import ray_tpu_torch.rllib.algorithms.ddpg, ray_tpu_torch.rllib.algorithms.dt\n"
        "import ray_tpu_torch.rllib.algorithms.dreamerv3, ray_tpu_torch.rllib.podracer.torch_env\n"
        "import ray_tpu_torch.rllib.podracer.anakin, ray_tpu_torch.rllib.podracer.sebulba\n"
        "import ray_tpu_torch.rllib.podracer.transport\n"
        "import ray_tpu_torch.tune, ray_tpu_torch.workflow, ray_tpu_torch.scripts.cli\n"
        "import ray_tpu_torch.job_submission, ray_tpu_torch.util, ray_tpu_torch.util.multiprocessing\n"
        "import ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler.kuberay_provider\n"
        "new = set(sys.modules) - before\n"
        # joblib is imported only by its backend's module, on request.
        f"print(sorted(m for m in new if m.split('.')[0] in {FORBIDDEN + ('joblib',)!r}\n"
        "             or m == 'ray_tpu_torch.util.joblib'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.serve.engine import InferenceEngine
    from ray_tpu_torch.train.huggingface import TransformersTrainer, _default_train_loop
    from ray_tpu_torch.train.mpmd import MPMDOptions, MPMDTrainer, StageRunner, run_local_pipeline
    from ray_tpu_torch.models.gbdt import GBDTParams, GradientBoostedTrees
    from ray_tpu_torch.rllib import EnvRunner, PPOConfig, make_env
    from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.core import DiscretePolicyModule
    from ray_tpu_torch.rllib.core.rl_module import params_from_numpy
    from ray_tpu_torch.rllib.env.multi_agent import make_multi_agent
    from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, ApexDQNConfig, BCConfig, CQLConfig, DDPGConfig,
                                     DQNConfig, DreamerV3Config, DTConfig, IMPALAConfig, MARWILConfig, SACConfig,
                                     TD3Config)
    from ray_tpu_torch.rllib.offline import EpisodeDataset, OfflineDataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    demos = OfflineDataset(np.zeros((8, 4), np.float32), np.zeros(8, np.int64), np.zeros(8, np.float32),
                           rewards=np.zeros(8, np.float32), next_obs=np.zeros((8, 4), np.float32),
                           dones=np.zeros(8, np.float32))
    episodes = EpisodeDataset([{"obs": np.zeros((3, 4), np.float32), "actions": np.zeros(3, np.int64),
                                "rewards": np.ones(3, np.float32)}])
    cfg = gpt.GPTConfig(vocab_size=16, n_layers=1, d_model=8, n_heads=2, d_head=4, d_mlp=16,
                        max_seq=16, dtype=torch.float32)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    np_params = {k: v.numpy() for k, v in params.items()}
    calls = [
        lambda: gpt.init_params(cfg),
        lambda: gpt.init_cache(cfg, 1),
        lambda: gpt.init_paged_cache(cfg, 4, 4),
        lambda: params_from_jax(np_params, cfg),
        lambda: InferenceEngine(cfg, params=params),
        lambda: InferenceEngine(cfg),
        lambda: StageRunner(cfg, 0, 1, 1, params),
        lambda: run_local_pipeline(cfg, 1, 1, 1, [np.zeros((1, 3), np.int64)], params=params),
        lambda: MPMDTrainer(cfg, MPMDOptions(num_stages=1), 1, lambda step: None),
        lambda: TransformersTrainer(model=(np_params, cfg), datasets={}),
        # A worker without a card, under a driver that has one: the loop refuses.
        lambda: _default_train_loop({"gpt_config": cfg, "init_params": None}),
        lambda: GradientBoostedTrees(GBDTParams(num_boost_round=1)).fit(np.zeros((4, 1), np.float32),
                                                                        np.zeros(4, np.float32)),
        lambda: EnvRunner(env_name="CartPole-v1", num_envs=2, module=DiscretePolicyModule(4, 2)),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: PPOConfig().environment("CartPole-v1").training(train_batch_size=64, minibatch_size=32).build(),
        lambda: MultiAgentPPOConfig().environment(
            ma_env_maker=make_multi_agent(lambda n, **kw: make_env("CartPole-v1", n), 2)
        ).multi_agent(shared_policy=True).build(),
        # The discrete-action algorithms: their learner and local runner.
        *[lambda c=c: c.environment("CartPole-v1").env_runners(num_env_runners=0).build()
          for c in (A2CConfig(), IMPALAConfig(), APPOConfig(), DQNConfig())],
        lambda: ApexDQNConfig().environment("CartPole-v1").build(),
        *[lambda c=c: c.environment("CartPole-v1").offline_data(dataset=demos).build()
          for c in (BCConfig(), MARWILConfig(), CQLConfig())],
        # The continuous-control algorithms and DT: their learner and local runner.
        *[lambda c=c: c.environment("Pendulum-v1").env_runners(num_env_runners=0).build()
          for c in (SACConfig(), TD3Config(), DDPGConfig())],
        lambda: DTConfig().environment("CartPole-v1").training(target_return=10.0).offline_data(episodes).build(),
        # DreamerV3: its learner and its local runner (the recurrent acting step).
        lambda: DreamerV3Config().environment("CartPole-v1").env_runners(num_env_runners=0).build(),
        # The podracer planes: Anakin's fused step, Sebulba's learner (before any cluster boots).
        *[lambda plane=plane: PPOConfig().environment("CartPole-v1").podracer(plane).build()
          for plane in ("anakin", "sebulba")],
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # With device="cpu" they run the plain path.
    eng = InferenceEngine(cfg, params=params, device="cpu")
    assert eng.kv["k"].device.type == "cpu"
    assert params_from_jax(np_params, cfg, device="cpu")["w_qkv"].device.type == "cpu"
    out = run_local_pipeline(cfg, 1, 1, 1, [np.zeros((1, 3), np.int64)], params=params, device="cpu")
    assert np.isfinite(out["history"][0]["loss"])
    assert StageRunner(cfg, 0, 1, 1, params, device="cpu").params["w_qkv"].device.type == "cpu"
    MPMDTrainer(cfg, MPMDOptions(num_stages=1, device="cpu"), 1, lambda step: None)
    _transformers_trainer_runs_on_the_cpu(cfg, np_params, TransformersTrainer)


def _transformers_trainer_runs_on_the_cpu(cfg, np_params, trainer_cls):
    """With device="cpu" the HF trainer's loop runs the plain path in a
    gang of one (local mode): one step, a finite loss, the params back."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data

    rt.init(local_mode=True)
    try:
        rows = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 9)).astype(np.int32)
        result = trainer_cls(model=(np_params, cfg), datasets={"train": data.from_numpy(rows, column="tokens")},
                             train_loop_config={"device": "cpu", "steps": 1, "batch_size": 2}).fit()
    finally:
        rt.shutdown()
    assert result.error is None and np.isfinite(result.metrics["loss"])
    assert set(result.checkpoint.to_dict()["params"]) == set(np_params)


def test_convert_checks_layer_axis():
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.convert import params_from_jax

    cfg = gpt.GPTConfig(vocab_size=16, n_layers=2, d_model=8, n_heads=2, d_head=4, d_mlp=16,
                        max_seq=16, dtype=torch.float32)
    np_params = {k: v.numpy() for k, v in gpt.init_params(cfg, seed=0, device="cpu").items()}
    np_params["w_o"] = np_params["w_o"][:1]
    with pytest.raises(ValueError, match="w_o"):
        params_from_jax(np_params, cfg, device="cpu")
    with pytest.raises(KeyError):
        params_from_jax({"tok_embed": np.zeros((16, 8), np.float32)}, cfg, device="cpu")
