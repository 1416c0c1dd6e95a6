// Flash attention for head dims above 256 (sm_90a), plain C interface: the
// wide-head route of the forward (with lse), dQ (with Delta) and dK/dV.
//
// Replaces, for 256 < D: ray_tpu/ops/attention.py `_flash_fwd_pallas`
// (`_flash_fwd_kernel`) and `_flash_bwd_pallas` (`_flash_bwd_dq_kernel`,
// `_flash_bwd_dkv_kernel`, Delta at `:439`). The reference's Pallas kernels
// take any head dim (they pad only the sequence); the tiled kernels of
// flash_fwd.cu and flash_bwd.cu hold whole head rows in registers and
// shared memory and are compiled for D <= 256. The op pads D to a multiple
// of 64 (exact: zero columns change neither Q K^T nor the first D columns
// of the products) and sends D > 256 here.
//
// Bound on the H100: as the tiled kernels', tensor-core operations at long
// sequences and bytes at short ones. These kernels are the simple, correct
// route: CUDA-core FMA with f32 accumulation for both dtypes, so they are
// bound by FMA issue and shared-memory reads, far from either bound. Making
// them fast is later work; no configuration of the repository has D > 256.
//
// Design: registers and shared memory stay bounded whatever D is.
//   * A block is 4 warps over 32 own rows (forward and dQ: q rows; dK/dV:
//     keys), 8 per warp, against stream tiles of 32 rows (keys; q rows),
//     one per lane.
//   * The reductions over the head dim (Q K^T, and dO V^T in the backward)
//     stream through shared memory 64 columns at a time, so a logit costs
//     no register per head-dim column. Delta = rowsum(dO o O) is read
//     straight from global memory, 4 columns a lane at a time.
//   * A block writes at most 128 output columns (grid z picks the chunk):
//     O[:, c] = P V[:, c]; dQ[:, c] = dS K[:, c]; dV[:, c] = P^T dO[:, c]
//     and dK[:, c] = dS^T Q[:, c]. Every chunk recomputes the logits, P and
//     dS for its columns; lse and Delta are written by chunk 0 only.
//   * Inputs of either dtype are read into f32 shared memory and every
//     product accumulates in f32. P is rounded to v's dtype before P V and
//     to dO's before P^T dO, dS to the input dtype, as
//     `flash_attention_plain` and `flash_attention_bwd_plain` state.
//   * Causal rows are end-aligned with the keys (query i sits at key
//     position i + Skv - S); key tiles past a q tile's last visible key are
//     skipped, as are q tiles before a key tile's first viewer. The causal
//     forward and dQ grids run the heaviest (last) q tiles first; dK/dV's
//     heaviest (first) key tiles are first already.
// The launch plan (rows per block, stream columns, the column chunk, the
// grid) is Python's (`flash_wide.plan`, tested on the CPU); this file
// refuses a plan it was not compiled for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kRows = 32;     // a block's own rows: 8 per warp
constexpr int kTile = 32;     // rows of a stream tile: one per lane
constexpr int kSC = 64;       // head-dim columns per reduction chunk
constexpr int kCC = 128;      // output columns of one block, at most
constexpr int kU = kCC / 32;  // output columns of one lane, at most
constexpr int kWarpRows = kRows / kWarps;

// What rt_flash_wide_* are handed: `flash_wide.LaunchPlan`, field for field.
struct WideLaunch {
  int block_rows, stream_cols, col_chunk, grid_x, grid_y, grid_z;
};

struct Str {  // (batch, head, seq) element strides of one tensor
  long long b, h, s;
};

struct Strides {  // q, k, v, o, dO (unused entries zero)
  Str t[5];
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  // What a cast to bf16 and back gives.
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
};

// rows x cols (cols a multiple of 4) of src, row r at src + r * stride,
// into f32 dst[r * ld + c]; zero for rows >= valid.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long stride, int rows,
                                          int valid, int cols) {
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int r = i / c4, c = (i % c4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = Elem<T>::load4(src + r * stride + c);
    float* d = dst + r * ld + c;
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i] += own[i] . stream[lane] over kSC columns: the warp's 8 own rows
// (read by broadcast) against the lane's stream row (read down its
// column of a [kTile][kSC + 1] tile, conflict free).
__device__ __forceinline__ void dot_chunk(float (&s)[kWarpRows], const float* own, const float* stream_row) {
#pragma unroll 8
  for (int d = 0; d < kSC; ++d) {
    const float x = stream_row[d];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) s[i] = fmaf(own[i * kSC + d], x, s[i]);
  }
}

// acc[i][u] += sum_j w[i][j] * tile[j][lane + 32u] for the lane's nu columns.
__device__ __forceinline__ void accumulate(float (&acc)[kWarpRows][kU], const float* w, const float* tile, int nu) {
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (u < nu) {
        const float x = tile[j * kCC + threadIdx.x % 32 + 32 * u];
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) acc[i][u] = fmaf(w[i * kTile + j], x, acc[i][u]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(T* out, long long row_stride, const float (&acc)[kWarpRows][kU],
                                           int r0, int valid, int nu, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    if (r0 + i >= valid) continue;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (u < nu) Elem<T>::store(out + (r0 + i) * row_stride + lane + 32 * u, acc[i][u] * mul);
  }
}

// ---------------------------------------------------------------- forward
constexpr size_t kFwdSmem = (kRows * kSC + kTile * (kSC + 1) + kTile * kCC + kRows * kTile) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int H, int S, int Skv, int D, Strides st, int causal, float scale,
               int cc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRows][kSC]: a chunk of the q rows
  float* Ks = Qs + kRows * kSC;                // [kTile][kSC + 1]: a chunk of the key tile
  float* Vs = Ks + kTile * (kSC + 1);          // [kTile][kCC]: v at the block's columns
  float* Ps = Vs + kTile * kCC;                // [kRows][kTile]: P, rounded to v's dtype
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.z * cc, nu = min(cc, D - c0) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * kWarpRows;
  const int row_offset = Skv - S;
  const T* qp = q + b * st.t[0].b + h * st.t[0].h + q0 * st.t[0].s;
  const T* kp = k + b * st.t[1].b + h * st.t[1].h;
  const T* vp = v + b * st.t[2].b + h * st.t[2].h + c0;
  float* Pw = Ps + r0 * kTile;

  const int kv_end = causal ? min(Skv, row_offset + min(q0 + kRows, S)) : Skv;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  float acc[kWarpRows][kU], m_run[kWarpRows], l_run[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m_run[i] = -INFINITY, l_run[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = 0.f;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    float s[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) s[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kSC) {
      __syncthreads();  // every read of the previous chunk (and tile) is done
      load_rows(Qs, kSC, qp + d0, st.t[0].s, kRows, S - q0, kSC);
      load_rows(Ks, kSC + 1, kp + k0 * st.t[1].s + d0, st.t[1].s, kTile, Skv - k0, kSC);
      __syncthreads();
      dot_chunk(s, Qs + r0 * kSC, Ks + lane * (kSC + 1));
    }
    load_rows(Vs, kCC, vp + k0 * st.t[2].s, st.t[2].s, kTile, Skv - k0, nu * 32);
    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int row = q0 + r0 + i;
      float x = s[i] * scale;
      if (col >= Skv || (causal && row + row_offset < col)) x = -INFINITY;
      const float m_new = fmaxf(m_run[i], warp_max(x));
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = expf(m_run[i] - m_use);
      const float p = expf(x - m_use);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
      Pw[i * kTile + lane] = Elem<T>::round(p);
#pragma unroll
      for (int u = 0; u < kU; ++u) acc[i][u] *= alpha;
    }
    __syncthreads();  // the v tile has landed
    accumulate(acc, Pw, Vs, nu);
  }

  float inv[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int row = q0 + r0 + i;
    inv[i] = 1.f / fmaxf(l_run[i], 1e-30f);
    if (lse != nullptr && blockIdx.z == 0 && lane == 0 && row < S)
      lse[(long long)bh * S + row] = m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
  }
  T* out = o + (long long)bh * S * D + c0;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (u < nu) Elem<T>::store(out + (long long)row * D + lane + 32 * u, acc[i][u] * inv[i]);
  }
}

// ---------------------------------------------------------------- dQ, Delta
constexpr size_t kDqSmem =
    (2 * kRows * kSC + 2 * kTile * (kSC + 1) + kTile * kCC + kRows * kTile) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, int H, int S, int Skv, int D, Strides st,
              int causal, float scale, int cc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kRows][kSC]: a chunk of the q rows
  float* Gs = Qs + kRows * kSC;                // [kRows][kSC]: the same chunk of dO
  float* Ks = Gs + kRows * kSC;                // [kTile][kSC + 1]: a chunk of the key tile
  float* Vs = Ks + kTile * (kSC + 1);          // [kTile][kSC + 1]: the same chunk of v
  float* Kc = Vs + kTile * (kSC + 1);          // [kTile][kCC]: the key tile at the block's columns
  float* Ds = Kc + kTile * kCC;                // [kRows][kTile]: dS, rounded to the input dtype
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.z * cc, nu = min(cc, D - c0) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * kWarpRows;
  const int row_offset = Skv - S;
  const T* qp = q + b * st.t[0].b + h * st.t[0].h + q0 * st.t[0].s;
  const T* kp = k + b * st.t[1].b + h * st.t[1].h;
  const T* vp = v + b * st.t[2].b + h * st.t[2].h;
  const T* op = o + b * st.t[3].b + h * st.t[3].h + q0 * st.t[3].s;
  const T* gp = dout + b * st.t[4].b + h * st.t[4].h + q0 * st.t[4].s;
  float* Dw = Ds + r0 * kTile;

  // Delta = rowsum(dO o O) and lse of the warp's rows.
  float dlt[kWarpRows], lrow[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int row = q0 + r0 + i;
    float sum = 0.f;
    if (row < S) {
      const T* orow = op + (r0 + i) * st.t[3].s;
      const T* grow = gp + (r0 + i) * st.t[4].s;
      for (int d = lane * 4; d < D; d += 128) {
        const float4 a = Elem<T>::load4(orow + d), g = Elem<T>::load4(grow + d);
        sum += a.x * g.x + a.y * g.y + a.z * g.z + a.w * g.w;
      }
    }
    dlt[i] = warp_sum(sum);
    lrow[i] = row < S ? lse[(long long)bh * S + row] : 0.f;
    if (blockIdx.z == 0 && lane == 0 && row < S) delta[(long long)bh * S + row] = dlt[i];
  }

  const int kv_end = causal ? min(Skv, row_offset + min(q0 + kRows, S)) : Skv;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  float acc[kWarpRows][kU];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    float s[kWarpRows], dp[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) s[i] = 0.f, dp[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kSC) {
      __syncthreads();
      load_rows(Qs, kSC, qp + d0, st.t[0].s, kRows, S - q0, kSC);
      load_rows(Gs, kSC, gp + d0, st.t[4].s, kRows, S - q0, kSC);
      load_rows(Ks, kSC + 1, kp + k0 * st.t[1].s + d0, st.t[1].s, kTile, Skv - k0, kSC);
      load_rows(Vs, kSC + 1, vp + k0 * st.t[2].s + d0, st.t[2].s, kTile, Skv - k0, kSC);
      __syncthreads();
      dot_chunk(s, Qs + r0 * kSC, Ks + lane * (kSC + 1));
      dot_chunk(dp, Gs + r0 * kSC, Vs + lane * (kSC + 1));
    }
    load_rows(Kc, kCC, kp + k0 * st.t[1].s + c0, st.t[1].s, kTile, Skv - k0, nu * 32);
    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int row = q0 + r0 + i;
      const bool seen = row < S && col < Skv && !(causal && row + row_offset < col);
      const float p = seen ? expf(s[i] * scale - lrow[i]) : 0.f;
      Dw[i * kTile + lane] = Elem<T>::round(p * (dp[i] - dlt[i]));
    }
    __syncthreads();  // the key tile's columns have landed
    accumulate(acc, Dw, Kc, nu);
  }
  store_rows(dq + (long long)bh * S * D + (long long)q0 * D + c0, D, acc, r0, S - q0, nu, scale);
}

// ---------------------------------------------------------------- dK, dV
constexpr size_t kDkvSmem =
    (2 * kRows * kSC + 2 * kTile * (kSC + 1) + 2 * kTile * kCC + 2 * kRows * kTile) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int H, int S, int Skv, int D, Strides st, int causal,
               float scale, int cc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [kRows][kSC]: a chunk of the block's keys
  float* Vs = Ks + kRows * kSC;                // [kRows][kSC]: the same chunk of v
  float* Qs = Vs + kRows * kSC;                // [kTile][kSC + 1]: a chunk of the q tile
  float* Gs = Qs + kTile * (kSC + 1);          // [kTile][kSC + 1]: the same chunk of dO
  float* Qc = Gs + kTile * (kSC + 1);          // [kTile][kCC]: the q tile at the block's columns
  float* Gc = Qc + kTile * kCC;                // [kTile][kCC]: dO at the block's columns
  float* Ps = Gc + kTile * kCC;                // [kRows][kTile]: P, rounded to dO's dtype
  float* Ds = Ps + kRows * kTile;              // [kRows][kTile]: dS, rounded to the input dtype
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.z * cc, nu = min(cc, D - c0) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * kWarpRows;
  const int row_offset = Skv - S;
  const T* qp = q + b * st.t[0].b + h * st.t[0].h;
  const T* kp = k + b * st.t[1].b + h * st.t[1].h + k0 * st.t[1].s;
  const T* vp = v + b * st.t[2].b + h * st.t[2].h + k0 * st.t[2].s;
  const T* gp = dout + b * st.t[4].b + h * st.t[4].h;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  float* Pw = Ps + r0 * kTile;
  float* Dw = Ds + r0 * kTile;

  // The q tiles with a row that sees one of the keys: end-aligned causal
  // row i sees keys <= i + Skv - S.
  const int first = causal ? max(0, k0 - row_offset) / kTile : 0;
  const int n_qt = (S + kTile - 1) / kTile;
  float ak[kWarpRows][kU], av[kWarpRows][kU];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) ak[i][u] = 0.f, av[i][u] = 0.f;
  for (int qt = first; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    float s[kWarpRows], dp[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) s[i] = 0.f, dp[i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kSC) {
      __syncthreads();
      load_rows(Ks, kSC, kp + d0, st.t[1].s, kRows, Skv - k0, kSC);
      load_rows(Vs, kSC, vp + d0, st.t[2].s, kRows, Skv - k0, kSC);
      load_rows(Qs, kSC + 1, qp + q0 * st.t[0].s + d0, st.t[0].s, kTile, S - q0, kSC);
      load_rows(Gs, kSC + 1, gp + q0 * st.t[4].s + d0, st.t[4].s, kTile, S - q0, kSC);
      __syncthreads();
      dot_chunk(s, Ks + r0 * kSC, Qs + lane * (kSC + 1));
      dot_chunk(dp, Vs + r0 * kSC, Gs + lane * (kSC + 1));
    }
    load_rows(Qc, kCC, qp + q0 * st.t[0].s + c0, st.t[0].s, kTile, S - q0, nu * 32);
    load_rows(Gc, kCC, gp + q0 * st.t[4].s + c0, st.t[4].s, kTile, S - q0, nu * 32);
    const int row = q0 + lane;
    const float lr = row < S ? lse_bh[row] : 0.f, dl = row < S ? delta_bh[row] : 0.f;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int key = k0 + r0 + i;
      const bool seen = row < S && key < Skv && !(causal && row + row_offset < key);
      const float p = seen ? expf(s[i] * scale - lr) : 0.f;
      Pw[i * kTile + lane] = Elem<T>::round(p);
      Dw[i * kTile + lane] = Elem<T>::round(p * (dp[i] - dl));
    }
    __syncthreads();  // the q and dO tiles' columns have landed
    accumulate(av, Pw, Gc, nu);
    accumulate(ak, Dw, Qc, nu);
  }
  const long long base = (long long)bh * Skv * D + (long long)k0 * D + c0;
  store_rows(dk + base, D, ak, r0, Skv - k0, nu, scale);
  store_rows(dv + base, D, av, r0, Skv - k0, nu, 1.f);
}

// ------------------------------------------------------------ host side
// Refuses a plan these kernels were not compiled for, or one that does not
// cover `rows` rows of B*H heads and D columns once.
bool plan_fits(const WideLaunch* p, int rows, int BH, int D) {
  return p != nullptr && p->block_rows == kRows && p->stream_cols == kSC && D > 0 && D % kSC == 0 &&
         p->col_chunk > 0 && p->col_chunk <= kCC && p->col_chunk % kSC == 0 &&
         p->grid_x == (rows + kRows - 1) / kRows && p->grid_y == BH && p->grid_y <= 65535 &&
         p->grid_z == (D + p->col_chunk - 1) / p->col_chunk && p->grid_z <= 65535;
}

// Byte strides to element strides; false if one is not a whole number of
// 4-element vectors (the kernels load 4 columns at a time).
bool element_strides(const long long* sb, int n, int elem, Strides& st) {
  st = Strides{};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 3; ++j)
      if (sb[3 * i + j] % (4 * elem) != 0) return false;
    st.t[i] = Str{sb[3 * i] / elem, sb[3 * i + 1] / elem, sb[3 * i + 2] / elem};
  }
  return true;
}

dim3 grid_of(const WideLaunch* p) { return dim3(p->grid_x, p->grid_y, p->grid_z); }

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int H, int S, int Skv,
                int D, const Strides& st, int causal, float scale, const WideLaunch* p, cudaStream_t stream) {
  flash_wide_fwd<T><<<grid_of(p), kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse,
      H, S, Skv, D, st, causal, scale, p->col_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
               float* delta, void* dq_out, int H, int S, int Skv, int D, const Strides& st, int causal,
               float scale, const WideLaunch* p, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err;
  if ((err = allow_smem(flash_wide_dq<T>, kDqSmem, configured)) != cudaSuccess) return err;
  flash_wide_dq<T><<<grid_of(p), kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq_out), H, S, Skv, D, st, causal, scale,
      p->col_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dk, void* dv, int H, int S, int Skv, int D, const Strides& st,
                int causal, float scale, const WideLaunch* p, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err;
  if ((err = allow_smem(flash_wide_dkv<T>, kDkvSmem, configured)) != cudaSuccess) return err;
  flash_wide_dkv<T><<<grid_of(p), kThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, S, Skv, D, st,
      causal, scale, p->col_chunk);
  return cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 on success) and takes the arguments of its
// tiled counterpart (rt_flash_fwd, rt_flash_bwd_dq, rt_flash_bwd_dkv):
// dtype 0 = float32, 1 = bfloat16; inputs [B, H, L, D] with unit stride
// along D and (batch, head, seq) strides in BYTES, each a multiple of 4
// elements; outputs contiguous [B, H, L, D]; lse and Delta contiguous
// [B*H, S] f32. D is a multiple of 64 (the op pads it). plan is a
// WideLaunch (`flash_wide.launch_plan`) for either dtype.
extern "C" int rt_flash_wide_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                                 int S, int Skv, int D, long long sqb, long long sqh, long long sqs,
                                 long long skb, long long skh, long long sks, long long svb, long long svh,
                                 long long svs, int causal, float scale, int dtype, const void* plan,
                                 void* stream) {
  const long long sb[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  const WideLaunch* p = static_cast<const WideLaunch*>(plan);
  const int elem = dtype == 0 ? 4 : 2;
  Strides st;
  if ((dtype != 0 && dtype != 1) || !plan_fits(p, S, B * H, D) || !element_strides(sb, 3, elem, st))
    return int(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? fwd<float>(q, k, v, o, l, H, S, Skv, D, st, causal, scale, p, s)
                        : fwd<__nv_bfloat16>(q, k, v, o, l, H, S, Skv, D, st, causal, scale, p, s));
}

extern "C" int rt_flash_wide_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                const void* lse, void* delta, void* dq_out, int B, int H, int S, int Skv, int D,
                                long long sqb, long long sqh, long long sqs, long long skb, long long skh,
                                long long sks, long long svb, long long svh, long long svs, long long sob,
                                long long soh, long long sos, long long sgb, long long sgh, long long sgs,
                                int causal, float scale, int dtype, const void* plan, void* stream) {
  const long long sb[15] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos, sgb, sgh, sgs};
  const WideLaunch* p = static_cast<const WideLaunch*>(plan);
  const int elem = dtype == 0 ? 4 : 2;
  Strides st;
  if ((dtype != 0 && dtype != 1) || !plan_fits(p, S, B * H, D) || !element_strides(sb, 5, elem, st))
    return int(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0
                 ? dq<float>(q, k, v, o, dout, l, dl, dq_out, H, S, Skv, D, st, causal, scale, p, s)
                 : dq<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq_out, H, S, Skv, D, st, causal, scale, p, s));
}

extern "C" int rt_flash_wide_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B, int H, int S, int Skv, int D,
                                 long long sqb, long long sqh, long long sqs, long long skb, long long skh,
                                 long long sks, long long svb, long long svh, long long svs, long long sgb,
                                 long long sgh, long long sgs, int causal, float scale, int dtype,
                                 const void* plan, void* stream) {
  // The stride slots are q, k, v, o, dO; this kernel reads no o.
  const long long sb[15] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, 0, 0, 0, sgb, sgh, sgs};
  const WideLaunch* p = static_cast<const WideLaunch*>(plan);
  const int elem = dtype == 0 ? 4 : 2;
  Strides st;
  if ((dtype != 0 && dtype != 1) || !plan_fits(p, Skv, B * H, D) || !element_strides(sb, 5, elem, st))
    return int(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? dkv<float>(q, k, v, dout, l, dl, dk, dv, H, S, Skv, D, st, causal, scale, p, s)
                        : dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, H, S, Skv, D, st, causal, scale,
                                             p, s));
}

// sizeof(WideLaunch): the wrapper checks its LaunchPlan against it.
extern "C" int rt_flash_wide_plan_bytes() { return int(sizeof(WideLaunch)); }
