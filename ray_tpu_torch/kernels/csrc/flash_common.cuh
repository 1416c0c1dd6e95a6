// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// bf16 tensor-core fragments of mma.sync m16n8k16 and the shared-memory tile
// loader. Fragment layouts (PTX ISA, m16n8k16 with .bf16 inputs), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   B (16x8, col-major):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
//   C/D (16x8, f32):      d0, d1 = C[g][2t..2t+1], d2, d3 = C[g+8][2t..2t+1].
// So the accumulators of two adjacent 8-column tiles hold, element for
// element, the A fragment of a 16-column slice: a product's f32 result is
// rounded to bf16 in registers and fed straight into the next product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // shared-memory row padding (elements): conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b, m16n8k16, A row-major bf16, B col-major bf16, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment of 16 rows x 16 columns of a row-major shared tile; `p` points
// at element [row0 + g][col0 + 2t], `ld` is the row stride in elements.
__device__ __forceinline__ void ld_a(const uint16_t* p, int ld, uint32_t (&a)[4]) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// A fragment from f32 accumulators of two adjacent 8-column tiles, rounded
// to bf16.
__device__ __forceinline__ void acc_to_a(const float (&lo)[4], const float (&hi)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// B fragment when the shared tile is stored [n][k] (a row per output
// column: K in Q K^T): `p` points at [n0 + g][k0 + 2t]; two 32-bit loads.
__device__ __forceinline__ void ld_b_nk(const uint16_t* p, uint32_t& b0, uint32_t& b1) {
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment when the shared tile is stored [k][n] (a row per reduction
// index: V in P V): `p` points at [k0 + 2t][n0 + g]; four 16-bit loads.
__device__ __forceinline__ void ld_b_kn(const uint16_t* p, int ld, uint32_t& b0, uint32_t& b1) {
  b0 = uint32_t(p[0]) | (uint32_t(p[ld]) << 16);
  b1 = uint32_t(p[8 * ld]) | (uint32_t(p[9 * ld]) << 16);
}

// rows x D tile from global (row stride `stride` elements) into shared
// memory [rows][D + kPad] with 16-byte loads; rows at or past `valid` are
// zero-filled so that masked entries never meet NaN garbage.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* src,
                                               long long stride, int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = val;
  }
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
