# reference: also exports `tpu` and TPUAcceleratorManager, ray_tpu/util/accelerators/__init__.py:1-16
from .accelerator import (
    AcceleratorManager,
    NvidiaGPUAcceleratorManager,  # reference: TPUAcceleratorManager too
    detect_node_accelerator_resources,
    get_accelerator_manager_for_resource,
    get_all_accelerator_managers,
    register_accelerator_manager,
)

__all__ = [
    "AcceleratorManager",
    "NvidiaGPUAcceleratorManager",  # reference: "tpu", "TPUAcceleratorManager" too
    "detect_node_accelerator_resources",
    "get_accelerator_manager_for_resource",
    "get_all_accelerator_managers",
    "register_accelerator_manager",
]
