"""Hand-written CUDA kernels for Hopper and their launch wrappers.

| wrapper | source | replaces (TPU Pallas kernel) |
| --- | --- | --- |
| `flash_fwd.flash_fwd` | `csrc/flash_fwd.cu` | `ray_tpu/ops/attention.py` `_flash_fwd_pallas` |
| `flash_bwd.flash_bwd_dq` | `csrc/flash_bwd.cu` | `_flash_bwd_pallas` (`_flash_bwd_dq_kernel`) |
| `flash_bwd.flash_bwd_dkv` | `csrc/flash_bwd.cu` | `_flash_bwd_pallas` (`_flash_bwd_dkv_kernel`) |
| `rmsnorm.rmsnorm_fwd` | `csrc/rmsnorm.cu` | `ray_tpu/ops/norms.py` `_rmsnorm_pallas` |

Each wrapper takes CUDA tensors only (the ops in `ray_tpu_torch/ops/` route
CPU tensors to the plain versions), launches on the current stream, raises
on a non-zero CUDA error, and counts its launches in `<wrapper>.launches`.
`build.library()` compiles `csrc/` with `nvcc` at first use; importing this
package builds nothing.
"""
