// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: ray_tpu/ops/attention.py `_flash_fwd_pallas` / `_flash_fwd_kernel`
// (the TPU Pallas kernel: online-softmax attention, end-aligned causal mask,
// ragged tail masked against the unpadded lengths, key blocks past the
// diagonal skipped, optional lse = m + log l).
//
// Bound on the H100: the causal forward does 4*D FLOPs per unmasked
// (query, key) pair, S(S+1)/2 pairs per head, against q, k, v read once and
// o written once (8*S*D bytes in bf16): (S+1)/4 FLOPs per byte. Below
// S ~ 1200 (the serving prompts here) that is under the ~295 FLOP/byte bf16
// break-even, so the bytes bound it; longer prompts are bound by tensor-core
// operations. Either way the design keeps every intermediate on chip: q, k,
// v are read once per tile and only o (and lse) is written.
//
// Design (bf16, the serving path):
//   * one block of 4 warps per (b*h, 64-row q tile); each warp owns 16 q rows;
//     blocks of the heaviest causal tiles are launched first;
//   * a loop over 64-row K/V tiles staged in shared memory with 16-byte loads
//     (rows padded by 8 elements so the fragment loads are bank-conflict free);
//   * S = Q K^T and O += P V on the tensor cores with mma.sync m16n8k16
//     (bf16 in, f32 accumulate); S, P and O never leave registers: the S
//     accumulator layout of two adjacent n-tiles IS the A-fragment layout of
//     the P V product, so P is rounded to bf16 in registers (as the reference
//     rounds p to v's dtype) and fed straight back;
//   * running max and sum in f32 registers (base-2 exponent), quad shuffles;
//   * causal: tiles past the diagonal are never loaded; only diagonal and
//     ragged-tail tiles evaluate the mask.
// Design (f32): the same tiling at 32x32 with plain FMA (no f32 tensor-core
// path is used: the reference kernel is dtype-generic and the f32 parity runs
// need full f32 products).
// Speed work (wgmma, TMA, warp specialisation, cp.async pipelining) is later.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

// ------------------------------------------------------------ bf16 path
constexpr int kBQ = 64;   // q rows per block, 16 per warp
constexpr int kBK = 64;   // key/value rows per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
               float* __restrict__ lse, int H, int S, int Skv, Strides st, int causal,
               float scale_log2) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Ks = Qs + kBQ * kLd;
  uint16_t* Vs = Ks + kBK * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_offset = Skv - S;  // end-aligned causal rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g;  // query row of d[0], d[1]; d[2], d[3] are r_lo + 8

  const uint16_t* qp = q + b * st.qb + h * st.qh;
  const uint16_t* kp = k + b * st.kb + h * st.kh;
  const uint16_t* vp = v + b * st.vb + h * st.vh;
  load_tile_bf16<D, kBQ>(Qs, qp + q0 * st.qs, st.qs, S - q0);

  const int kv_end = causal ? min(Skv, row_offset + min(q0 + kBQ, S)) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, kBK>(Ks, kp + k0 * st.ks, st.ks, Skv - k0);
    load_tile_bf16<D, kBK>(Vs, vp + k0 * st.vs, st.vs, Skv - k0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint16_t* qa = Qs + (warp * 16 + g) * kLd + kk * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * kLd);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * kLd + 8);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint16_t* kb = Ks + (j * 8 + g) * kLd + kk * 16 + 2 * t;
        mma16816(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // Scale into log2 units; mask only diagonal / ragged-tail tiles.
    const bool edge = (k0 + kBK > Skv) || (causal && k0 + kBK - 1 > row_offset + q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int row = r_lo + (e >> 1) * 8;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= Skv || (causal && row + row_offset < col)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // A row with no valid key yet (only rows past S) keeps m = -inf; use
      // 0 as its reference so exp2 gives 0, never NaN.
      m_use[i] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - m_use[i]);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (16 x 64) from registers, V (64 x D) from shared memory.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vr = Vs + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const uint16_t* vc = vr + n * 8;
        const uint32_t b0 = uint32_t(vc[0]) | (uint32_t(vc[kLd]) << 16);
        const uint32_t b1 = uint32_t(vc[8 * kLd]) | (uint32_t(vc[9 * kLd]) << 16);
        mma16816(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  // Full row sums across the quad, then normalize and store.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + i * 8;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    uint16_t* orow = o + ((long long)bh * S + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(long long)bh * S + row] = (m_run[i] + log2f(fmaxf(l_run[i], 1e-30f))) * 0.69314718055994531f;
  }
}

// ------------------------------------------------------------- f32 path
constexpr int kBQ32 = 32;  // q rows per block, 8 per warp
constexpr int kBK32 = 32;  // keys per tile: one per lane

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int S, int Skv, Strides st, int causal, float scale) {
  constexpr int kU = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [32][D]
  float* Ks = Qs + kBQ32 * D;                   // [32][D + 1]: conflict-free column reads
  float* Vs = Ks + kBK32 * (D + 1);             // [32][D]
  float* Ps = Vs + kBK32 * D;                   // [4 warps][8 rows][32 keys]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_offset = Skv - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Pw = Ps + warp * 8 * 32;

  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  for (int i = threadIdx.x; i < kBQ32 * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) val = *reinterpret_cast<const float4*>(qp + (q0 + r) * st.qs + c);
    *reinterpret_cast<float4*>(Qs + r * D + c) = val;
  }

  const int kv_end = causal ? min(Skv, row_offset + min(q0 + kBQ32, S)) : Skv;
  const int n_tiles = (kv_end + kBK32 - 1) / kBK32;

  float acc[8][kU];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = 0.f;
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m_run[i] = -INFINITY, l_run[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < Skv) {
        kv4 = *reinterpret_cast<const float4*>(kp + (k0 + r) * st.ks + c);
        vv4 = *reinterpret_cast<const float4*>(vp + (k0 + r) * st.vs + c);
      }
      float* kd = Ks + r * (D + 1) + c;
      kd[0] = kv4.x, kd[1] = kv4.y, kd[2] = kv4.z, kd[3] = kv4.w;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vv4;
    }
    __syncthreads();

    // Lane owns key k0 + lane; s[i] is its logit against query row i.
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * (D + 1);
    const float* qw = Qs + warp * 8 * D;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = fmaf(qw[i * D + d], kd, s[i]);
    }
    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + warp * 8 + i;
      float x = s[i] * scale;
      if (col >= Skv || (causal && row + row_offset < col)) x = -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = expf(m_run[i] - m_use);
      const float p = expf(x - m_use);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[i] = l_run[i] * alpha + ps;
      m_run[i] = m_new;
      Pw[i * 32 + lane] = p;
#pragma unroll
      for (int u = 0; u < kU; ++u) acc[i][u] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < kBK32; ++j) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float vj = Vs[j * D + lane + 32 * u];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][u] = fmaf(Pw[i * 32 + j], vj, acc[i][u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    float* orow = o + ((long long)bh * S + row) * D;
#pragma unroll
    for (int u = 0; u < kU; ++u) orow[lane + 32 * u] = acc[i][u] * inv;
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * S + row] = m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                   int S, int Skv, const Strides& st, int causal, float scale, int dtype,
                   cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = size_t(kBQ + 2 * kBK) * (D + kPad) * sizeof(uint16_t);
    static bool configured = false;
    if ((err = allow_smem(flash_fwd_bf16<D>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((S + kBQ - 1) / kBQ, B * H);
    flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), lse, H, S, Skv, st, causal,
        scale * 1.4426950408889634f);
  } else {
    const size_t smem =
        (size_t(kBQ32) * D + size_t(kBK32) * (D + 1) + size_t(kBK32) * D + kWarps * 8 * 32) *
        sizeof(float);
    static bool configured = false;
    if ((err = allow_smem(flash_fwd_f32<D>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((S + kBQ32 - 1) / kBQ32, B * H);
    flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, H, S, Skv, st, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16.
// q/k/v are [B, H, S|Skv, D] with unit stride along D and the given
// (batch, head, seq) element strides; o is contiguous [B, H, S, D]; lse,
// when not NULL, is contiguous [B*H, S] f32.
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int S, int Skv, int D, long long sqb, long long sqh,
                            long long sqs, long long skb, long long skh, long long sks,
                            long long svb, long long svh, long long svs, int causal, float scale,
                            int dtype, void* stream) {
  const Strides st{sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 32: return int(launch<32>(q, k, v, o, l, B, H, S, Skv, st, causal, scale, dtype, s));
    case 64: return int(launch<64>(q, k, v, o, l, B, H, S, Skv, st, causal, scale, dtype, s));
    case 128: return int(launch<128>(q, k, v, o, l, B, H, S, Skv, st, causal, scale, dtype, s));
    case 256: return int(launch<256>(q, k, v, o, l, B, H, S, Skv, st, causal, scale, dtype, s));
    default: return int(cudaErrorInvalidValue);
  }
}
