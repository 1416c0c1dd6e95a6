"""Which workers see the card.

The runtime keeps one accelerator worker kind (the reference's TPU worker,
`ray_tpu/core/controller.py:1224-1236`): tasks and actors that demand
`ACCELERATOR` run in workers that see the node's cards (forked from the
template, which imported torch without touching CUDA, or cold-spawned
while it is not ready). Every other worker, and the forkserver template,
sees none. This module imports nothing of the runtime, so the controller,
the node agents and the template can all use it.
"""

from __future__ import annotations

from typing import Dict

# The resource key of the accelerator worker kind (reference: "TPU").
ACCELERATOR = "GPU"


def pin_worker_devices(env: Dict[str, str], accelerator: bool, n_devices: float) -> None:
    """Set a spawning worker's `CUDA_VISIBLE_DEVICES` in `env`: for an
    accelerator worker the node's cards (the inherited value when it names
    any, else ids 0..n_devices-1), for every other worker none (""), the
    counterpart of the reference pinning CPU workers to `JAX_PLATFORMS=cpu`."""
    if not accelerator:
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif not env.get("CUDA_VISIBLE_DEVICES"):
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(max(1, int(n_devices))))
