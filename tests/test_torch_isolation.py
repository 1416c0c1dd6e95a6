"""The port stands alone: no module of `ray_tpu_torch/`, and not
`chip_smoke.py`, imports `jax` or anything of the JAX package `ray_tpu`,
or names a module of `ray_tpu` in a string (a `-m` path boots the
reference's processes); importing the port loads neither; and its entry
points refuse to run without a card unless the caller asks for the CPU.

The runtime is a copy of the reference's (`RUNTIME_COPY`): each copied
file equals its reference after the import rewrite (`rewrite`), except the
files in `DIVERGES`, where every changed line sits next to a comment that
names the reference line it replaces."""

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
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


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
)
# Port-only files inside the copied directories.
PORT_ONLY = {"core/devices.py", "core/host_names.py"}
# Copied files that diverge from the reference, and why.
DIVERGES = {
    "core/api.py": "init(num_gpus=...) sets the GPU resource",
    "core/controller.py": "GPU worker kind: resource key, device pinning, GPU lease spawns",
    "core/direct.py": "GPU worker kind: resource key of a lease",
    "core/node_agent.py": "GPU worker kind: device pinning",
    "core/forkserver.py": "template pre-imports torch, no card; reports its state",
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
}


def rewrite(text: str) -> str:
    """The reference's text with its own name replaced by the port's:
    imports and module paths in strings. (The session root and the shm
    prefix are no rewrite: the port's follow TMPDIR and differ, `DIVERGES`.)"""
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)


def _copied():
    out = []
    for entry in RUNTIME_COPY:
        ref = REF / entry
        files = sorted(f for f in ref.rglob("*") if f.is_file()) if ref.is_dir() else [ref]
        out += [f.relative_to(REF).as_posix() for f in files
                if "__pycache__" not in f.parts and "_build" not in f.parts]
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
    ref, port = (REF / rel).read_bytes(), (PORT / rel).read_bytes()
    if rel.endswith("_pb2.py") or rel.endswith(".proto"):
        assert port == ref, "generated protobuf and its source stay byte-identical"
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
        "new = set(sys.modules) - before\n"
        f"print(sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # With device="cpu" they run the plain path.
    eng = InferenceEngine(cfg, params=params, device="cpu")
    assert eng.kv["k"].device.type == "cpu"
    assert params_from_jax(np_params, cfg, device="cpu")["w_qkv"].device.type == "cpu"


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
