"""Accelerator manager plugin layer.

Reference analog: `python/ray/_private/accelerators/accelerator.py`
(`AcceleratorManager` ABC) with per-vendor implementations
(`tpu.py`, `nvidia_gpu.py`, ...) consulted at node start to autodetect
resources and at task launch to pin visible devices.

Here the NVIDIA GPU is the first-class citizen (the port runs on CUDA);
new accelerators register via `register_accelerator_manager`. Detection
never creates a CUDA context: it reads `CUDA_VISIBLE_DEVICES`, the
driver's `/proc` entry or `nvidia-smi -L`. (reference: TPU first,
ray_tpu/util/accelerators/accelerator.py:8-10)
"""

from __future__ import annotations

import os
import shutil  # reference: none (nvidia-smi detection)
import subprocess
from typing import Dict, List, Optional


class AcceleratorManager:
    """One per accelerator family. All methods are static-like (managers are
    stateless singletons)."""

    # e.g. "TPU" / "GPU" — the resource key users request.
    resource_name: str = ""

    def get_current_node_num_accelerators(self) -> int:
        """How many devices of this family this node carries."""
        raise NotImplementedError

    def get_current_node_accelerator_type(self) -> Optional[str]:
        """e.g. 'v5litepod-16' or 'A100'; None if undetectable."""
        return None

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        """Env var used to pin a worker to specific devices."""
        return None

    def set_visible_accelerator_ids(self, ids: List[str]) -> None:
        var = self.get_visible_accelerator_ids_env_var()
        if var:
            os.environ[var] = ",".join(ids)

    def get_extra_node_resources(self) -> Dict[str, float]:
        """Additional custom resources this node should advertise (e.g. the
        TPU pod-head gang resource)."""
        return {}

    def validate_resource_request_quantity(self, quantity: float) -> None:
        if quantity < 0:
            raise ValueError(f"{self.resource_name} request must be >= 0")


# reference: TPUAcceleratorManager, ray_tpu/util/accelerators/accelerator.py:53-88 (not copied)
class NvidiaGPUAcceleratorManager(AcceleratorManager):
    resource_name = "GPU"

    def get_current_node_num_accelerators(self) -> int:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            # "-1" (and any negative id) is the standard hide-all marker.
            return len([
                c for c in visible.split(",")
                if c.strip() != "" and not c.strip().startswith("-")
            ])
        try:
            entries = os.listdir("/proc/driver/nvidia/gpus")
            return len(entries)
        except OSError:
            return _nvidia_smi_count()  # reference: 0, ray_tpu/util/accelerators/accelerator.py:104

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        return "CUDA_VISIBLE_DEVICES"


def _nvidia_smi_count() -> int:
    """Cards `nvidia-smi -L` lists (one "GPU <i>: ..." line each): for
    containers without the driver's /proc entry. Creates no CUDA context."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return 0
    try:
        out = subprocess.run([exe, "-L"], capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))


_MANAGERS: Dict[str, AcceleratorManager] = {  # reference: TPU first, ray_tpu/util/accelerators/accelerator.py:112
    "GPU": NvidiaGPUAcceleratorManager(),
}


def register_accelerator_manager(manager: AcceleratorManager):
    if not manager.resource_name:
        raise ValueError("accelerator manager needs a resource_name")
    _MANAGERS[manager.resource_name] = manager


def get_all_accelerator_managers() -> List[AcceleratorManager]:
    return list(_MANAGERS.values())


def get_accelerator_manager_for_resource(
    resource_name: str,
) -> Optional[AcceleratorManager]:
    return _MANAGERS.get(resource_name)


def detect_node_accelerator_resources() -> Dict[str, float]:
    """Autodetected accelerator resources for this node (used by init when
    the user does not specify them)."""
    out: Dict[str, float] = {}
    for mgr in _MANAGERS.values():
        n = mgr.get_current_node_num_accelerators()
        if n > 0:
            out[mgr.resource_name] = float(n)
            out.update(mgr.get_extra_node_resources())
    return out
