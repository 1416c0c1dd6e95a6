"""The port stands alone: no module of `ray_tpu_torch/`, and not
`chip_smoke.py`, imports `jax` or anything of the JAX package `ray_tpu`;
importing the port loads neither; and its entry points refuse to run
without a card unless the caller asks for the CPU."""

import ast
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


def test_importing_the_port_loads_neither_jax_nor_ray_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.serve.engine, ray_tpu_torch.kernels.build\n"
        "import ray_tpu_torch.kernels.flash_fwd, ray_tpu_torch.kernels.rmsnorm\n"
        "import ray_tpu_torch.kernels.flash_bwd, ray_tpu_torch.optim\n"
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
