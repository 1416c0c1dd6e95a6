// RMSNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces: ray_tpu/ops/norms.py `_rmsnorm_pallas` / `_rmsnorm_kernel`:
// y = (f32(x) * rsqrt(mean(f32(x)^2) + eps)) * f32(w), rounded once to x's
// dtype; x [N, D] in f32 or bf16, w [D] in its own dtype (f32 or bf16).
//
// Bound on the H100: ~4 operations per element against 4 (bf16) or 8 (f32)
// bytes read and written, so memory bandwidth bounds it: the least time is
// (N*D x read + N*D y written + D w read) bytes over 3.35 TB/s. What the
// design does about it: one launch (the weight is read in its own dtype, no
// cast kernel before it), one read of x (the row stays on chip from the sum
// of squares to the scaled write), the weight read once per CTA, and bytes in
// flight by design rather than by occupancy.
//
// Paths (`kernels/rmsnorm.py` `plan` chooses one and sizes it; this file
// refuses a plan it was not compiled for):
//   regs    rows 16-byte aligned (base, row stride, row bytes) and at most
//           512 threads x 2 vectors wide, held in registers from the sum of
//           squares to the scaled write by persistent CTAs of R row slots x
//           T threads that read the weight once. Each thread starts the
//           16-byte loads of its next group of rows before the current
//           group's reduction, so one group is in flight while another is
//           reduced and written. A row of T = 32 threads reduces with
//           shuffles only; a wider row adds one named barrier (partials
//           double-buffered: one barrier per row). A TMA bulk-copy ring in
//           shared memory measured slower at every main-path shape and was
//           taken out (PERF.md, the RMSNorm findings): at these shapes a
//           CTA's turn (load, reduce, write) is set by its latency, and the
//           ring added a shared-memory hop and barrier waits to it.
//   vector  aligned rows too wide for registers: two passes over the row
//           (the second from L1/L2) with 16-byte loads, 256 threads a row.
//   scalar  any other row (an odd base or row stride, D not a multiple of
//           the vector width): the two passes with element loads.
// The reduction order is fixed by the plan: the same input gives the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kMaxConsumers = 512;  // R * T threads of a regs CTA
constexpr int kMaxWarps = kMaxConsumers / 32;
constexpr int kRowsThreads = 256;   // threads of a vector / scalar CTA
constexpr int kPartialBytes = 2 * kMaxWarps * 4;  // double-buffered per-warp partial sums

enum Path { kRegs = 0, kVector = 1, kScalar = 2 };

// The launch plan (`rmsnorm.LaunchPlan`, field for field).
struct RmsLaunch {
  int path, threads_per_row, rows_per_cta, nv, smem_bytes, grid, block_threads, w_vec;
};

template <int B> struct Elem;
template <> struct Elem<4> { using T = float; };
template <> struct Elem<2> { using T = __nv_bfloat16; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element i (f32) of values packed in 32-bit words: B = 4 (f32) or 2 (bf16,
// the high half of an f32, so the upcast is a shift).
template <int B> __device__ __forceinline__ float unpack(const uint32_t* u, int i);
template <> __device__ __forceinline__ float unpack<4>(const uint32_t* u, int i) { return __uint_as_float(u[i]); }
template <> __device__ __forceinline__ float unpack<2>(const uint32_t* u, int i) {
  const uint32_t w = u[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// 16 bytes of y from f32 values, rounded to nearest even.
template <int B> __device__ __forceinline__ uint4 pack(const float (&v)[16 / B]);
template <> __device__ __forceinline__ uint4 pack<4>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack<2>(const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    u[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void copy_vec(uint32_t (&d)[4], uint4 v) { d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w; }

// What a regs thread holds: its NV 16-byte vectors of x (vector i is
// the row's vector t + i*T), and the weight of the same columns in w's own
// dtype (WW words per vector), read once per CTA.
template <int XB, int WB, int NV>
struct RowThread {
  static constexpr int V = 16 / XB;       // elements of a 16-byte vector of x
  static constexpr int WW = V * WB / 4;   // 32-bit words of weight per vector
  int T, R, slot, t, warp, lane, wpr, VR, D, N;
  uint32_t w[NV][WW];

  __device__ __forceinline__ void init(const RmsLaunch& p, int n, int d) {
    T = p.threads_per_row;
    R = p.rows_per_cta;
    slot = threadIdx.x / T;
    t = threadIdx.x % T;
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wpr = T / 32;
    D = d;
    N = n;
    VR = d * XB / 16;
  }

  __device__ __forceinline__ bool has(int i) const { return t + i * T < VR; }

  __device__ __forceinline__ void load_weight(const unsigned char* wp, bool vec) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!has(i)) continue;
      const unsigned char* src = wp + size_t(t + i * T) * (WW * 4);
      if (vec) {
        if constexpr (WW == 2) {
          const uint2 a = __ldg(reinterpret_cast<const uint2*>(src));
          w[i][0] = a.x, w[i][1] = a.y;
        } else {
#pragma unroll
          for (int k = 0; k < WW / 4; ++k) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(src) + k);
            w[i][4 * k] = a.x, w[i][4 * k + 1] = a.y, w[i][4 * k + 2] = a.z, w[i][4 * k + 3] = a.w;
          }
        }
      } else if constexpr (WB == 4) {  // a weight that is not 16-byte aligned: element loads
#pragma unroll
        for (int k = 0; k < WW; ++k) w[i][k] = __ldg(reinterpret_cast<const unsigned int*>(src) + k);
      } else {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int k = 0; k < WW; ++k) w[i][k] = uint32_t(__ldg(e + 2 * k)) | (uint32_t(__ldg(e + 2 * k + 1)) << 16);
      }
    }
  }

  // This thread's part of the row's sum of squares.
  __device__ __forceinline__ float sumsq(const uint32_t (&x)[NV][4]) const {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!has(i)) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = unpack<XB>(x[i], e);
        ss = fmaf(f, f, ss);
      }
    }
    return ss;
  }

  // The row's sum of squares from the threads' parts (every thread of the
  // slot gets the same value), the scale, and y written with 16-byte stores.
  __device__ __forceinline__ void finish(const uint32_t (&x)[NV][4], float ss, int row, float eps, float* part,
                                         unsigned char* y) const {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (wpr > 1) {
      if (lane == 0) part[warp] = ss;
      named_bar_sync(1 + slot, T);
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += part[slot * wpr + k];
    }
    const float r = rsqrtf(ss / float(D) + eps);
    unsigned char* yr = y + size_t(row) * D * XB;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (!has(i)) continue;
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = (unpack<XB>(x[i], e) * r) * unpack<WB>(w[i], e);
      *reinterpret_cast<uint4*>(yr + size_t(t + i * T) * 16) = pack<XB>(v);
    }
  }
};

// regs: 16-byte loads into registers, the next group's started before the
// current group's reduction.
template <int XB, int WB, int NV>
__global__ void __launch_bounds__(kMaxConsumers, 2)
rmsnorm_regs(const unsigned char* __restrict__ x, const unsigned char* __restrict__ wp,
             unsigned char* __restrict__ y, int N, int D, long long stride_bytes, float eps, const RmsLaunch p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  RowThread<XB, WB, NV> th;
  th.init(p, N, D);
  th.load_weight(wp, p.w_vec);
  const int n_groups = (N + th.R - 1) / th.R;
  auto load = [&](uint32_t (&xv)[NV][4], int grp) {
    const int row = grp * th.R + th.slot;
    if (row >= N) return;
    const unsigned char* src = x + row * stride_bytes;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (th.has(i)) copy_vec(xv[i], __ldg(reinterpret_cast<const uint4*>(src + size_t(th.t + i * th.T) * 16)));
  };
  auto finish = [&](const uint32_t (&xv)[NV][4], int grp, int g) {
    const int row = grp * th.R + th.slot;
    if (row < N) th.finish(xv, th.sumsq(xv), row, eps, part + (g & 1) * kMaxWarps, y);
  };
  uint32_t a[NV][4], b[NV][4];
  int grp = blockIdx.x;
  if (grp >= n_groups) return;
  load(a, grp);
  for (int g = 0;; g += 2) {
    if (grp + int(gridDim.x) < n_groups) load(b, grp + gridDim.x);
    finish(a, grp, g);
    grp += gridDim.x;
    if (grp >= n_groups) break;
    if (grp + int(gridDim.x) < n_groups) load(a, grp + gridDim.x);
    finish(b, grp, g + 1);
    grp += gridDim.x;
    if (grp >= n_groups) break;
  }
}

// vector / scalar: a row per 256-thread CTA at a time, two passes (the
// second from L1/L2), 16-byte (VEC) or element loads; any D.
template <int XB, int WB, bool VEC>
__global__ void __launch_bounds__(kRowsThreads, 4)
rmsnorm_rows(const unsigned char* __restrict__ x, const unsigned char* __restrict__ wp,
             unsigned char* __restrict__ y, int N, int D, long long stride_bytes, float eps) {
  using TX = typename Elem<XB>::T;
  using TW = typename Elem<WB>::T;
  constexpr int V = VEC ? 16 / XB : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);
  const TW* w = reinterpret_cast<const TW*>(wp);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = blockIdx.x, g = 0; row < N; row += gridDim.x, ++g) {
    const TX* xr = reinterpret_cast<const TX*>(x + row * stride_bytes);
    TX* yr = reinterpret_cast<TX*>(y + size_t(row) * D * XB);
    float ss = 0.f;
    for (int c = threadIdx.x * V; c < D; c += kRowsThreads * V) {
      if constexpr (VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
        const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) ss = fmaf(to_f32(e[i]), to_f32(e[i]), ss);
      } else {
        const float f = to_f32(xr[c]);
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    float* pb = part + (g & 1) * kMaxWarps;
    if (lane == 0) pb[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int k = 0; k < kRowsThreads / 32; ++k) ss += pb[k];
    const float r = rsqrtf(ss / float(D) + eps);
    for (int c = threadIdx.x * V; c < D; c += kRowsThreads * V) {
      if constexpr (VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
        const TX* e = reinterpret_cast<const TX*>(&raw);
        uint4 out;
        TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = from_f32<TX>((to_f32(e[i]) * r) * to_f32(w[c + i]));
        *reinterpret_cast<uint4*>(yr + c) = out;
      } else {
        yr[c] = from_f32<TX>((to_f32(xr[c]) * r) * to_f32(w[c]));
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Does p describe a launch these kernels were compiled for, on these
// pointers?
bool plan_ok(const RmsLaunch& p, const void* x, const void* w, const void* y, int N, int D, long long stride_bytes,
             int XB) {
  const bool rows16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && stride_bytes % 16 == 0 &&
                      (long long)D * XB % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (p.grid < 1 || p.smem_bytes != kPartialBytes) return false;
  if (p.path == kVector || p.path == kScalar) {
    return p.block_threads == kRowsThreads && p.rows_per_cta == 1 && (p.path == kScalar || rows16);
  }
  if (p.path != kRegs) return false;
  const int T = p.threads_per_row, R = p.rows_per_cta, VR = D * XB / 16;
  if (!rows16 || T % 32 || T < 32 || R < 1 || R * T > kMaxConsumers || (T > 32 && R > 15)) return false;
  if (p.nv != 1 && p.nv != 2) return false;
  if ((long long)p.nv * T < VR || p.grid > ceil_div(N, R)) return false;
  if (p.w_vec && reinterpret_cast<uintptr_t>(w) % 16) return false;
  return p.block_threads == R * T;
}

template <int XB, int WB>
cudaError_t launch(const RmsLaunch& p, cudaStream_t s, const void* xv, const void* wv, void* yv, int N, int D,
                   long long stride_bytes, float eps) {
  const auto* x = static_cast<const unsigned char*>(xv);
  const auto* w = static_cast<const unsigned char*>(wv);
  auto* y = static_cast<unsigned char*>(yv);
  if (p.path == kVector || p.path == kScalar) {
    auto kernel = p.path == kVector ? rmsnorm_rows<XB, WB, true> : rmsnorm_rows<XB, WB, false>;
    kernel<<<p.grid, kRowsThreads, p.smem_bytes, s>>>(x, w, y, N, D, stride_bytes, eps);
    return cudaGetLastError();
  }
  auto kernel = p.nv == 1 ? rmsnorm_regs<XB, WB, 1> : rmsnorm_regs<XB, WB, 2>;
  kernel<<<p.grid, p.block_threads, p.smem_bytes, s>>>(x, w, y, N, D, stride_bytes, eps, p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). x_dtype / w_dtype: 0 = float32,
// 1 = bfloat16. x is [N, D] with unit stride along D and `row_stride`
// elements between rows; w is contiguous [D]; y is contiguous [N, D] in x's
// dtype. `plan` is rmsnorm.LaunchPlan; a plan these kernels were not
// compiled for, or that does not fit the pointers, is refused
// (cudaErrorInvalidValue).
extern "C" int rt_rmsnorm(const void* x, const void* w, void* y, int N, int D, long long row_stride, float eps,
                          int x_dtype, int w_dtype, const void* launch_plan, void* stream) {
  const RmsLaunch* plan = static_cast<const RmsLaunch*>(launch_plan);
  if (plan == nullptr || N < 1 || D < 1 || x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return int(cudaErrorInvalidValue);
  const int XB = x_dtype == 1 ? 2 : 4;
  const long long stride_bytes = row_stride * XB;
  if (!plan_ok(*plan, x, w, y, N, D, stride_bytes, XB)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && w_dtype == 1) return int(launch<2, 2>(*plan, s, x, w, y, N, D, stride_bytes, eps));
  if (x_dtype == 1) return int(launch<2, 4>(*plan, s, x, w, y, N, D, stride_bytes, eps));
  if (w_dtype == 1) return int(launch<4, 2>(*plan, s, x, w, y, N, D, stride_bytes, eps));
  return int(launch<4, 4>(*plan, s, x, w, y, N, D, stride_bytes, eps));
}

extern "C" int rt_rmsnorm_plan_bytes() { return int(sizeof(RmsLaunch)); }

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
