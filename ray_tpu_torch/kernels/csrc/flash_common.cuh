// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the f32 kernels' block shape and shared-memory tile loader, bf16 packing,
// and the dynamic shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x D f32 tile into shared memory [rows][LD] (LD = D, or D + 1 for
// tiles read down their columns), zero past `valid`.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long stride,
                                              int valid) {
  for (int i = threadIdx.x; i < ROWS * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + r * stride + c);
    float* d = dst + r * LD + c;
    d[0] = val.x, d[1] = val.y, d[2] = val.z, d[3] = val.w;
  }
}

// Raise a kernel's dynamic shared-memory limit once per process, before any
// CUDA-graph capture can include a launch of it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace
