// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dQ and dK/dV.
//
// Replaces: ray_tpu/ops/attention.py `_flash_bwd_pallas`, whose two
// pallas_calls run `_flash_bwd_dq_kernel` (dQ over q blocks, streaming k
// blocks up to the causal diagonal) and `_flash_bwd_dkv_kernel` (dK/dV over
// k blocks, streaming q blocks from the first one that reaches the
// diagonal). FlashAttention-2 arithmetic against the forward's saved lse:
//   P  = exp(S*scale - lse), masked to 0;      dP = dO V^T;
//   dS = P o (dP - Delta), Delta = rowsum(dO o O) (computed by the caller);
//   dQ = scale * dS K;  dK = scale * dS^T Q;  dV = P^T dO,
// with dS rounded to the input dtype before its products and P rounded to
// dO's dtype before P^T dO, as the reference rounds them.
//
// Bound on the H100: per unmasked (query, key) pair the dQ kernel does
// 6*D FLOPs (S, dP, dS K) and the dK/dV kernel 8*D (S^T, dP^T, P^T dO,
// dS^T Q), against q, k, v, dO read once and the gradients written once:
// at the training shape (S = 1024, D = 64, bf16, causal) both are bound by
// tensor-core operations, just above the bytes. The split into two passes
// keeps the reference's design: no atomics, dQ is deterministic; S and dP
// are recomputed in each pass (10*D FLOPs per pair would do).
//
// Design (bf16): one block of 4 warps per (b*h, 64-row tile), 16 rows per
// warp, mma.sync m16n8k16 (bf16 in, f32 accumulate) for every product;
// tiles staged in shared memory with 16-byte loads into rows padded by 8
// elements (conflict-free fragment loads for D = 32..256).
//   * dQ: a loop over K/V tiles up to the causal diagonal (end-aligned rows,
//     row_offset = Skv - S); tiles past it are never loaded, only diagonal
//     and ragged tiles evaluate the mask. S = Q K^T and dP = dO V^T share
//     one pass over D; dS is formed in the accumulator registers, which are
//     then the A fragments of dS K (K read as the [k][n] B operand).
//   * dK/dV: each warp owns 16 keys; a loop over Q/dO tiles from the first
//     that reaches the diagonal. It computes S^T = K Q^T and dP^T = V dO^T
//     directly, so the accumulators of P^T and dS^T are already the A
//     fragments of P^T dO and dS^T Q; lse and Delta are indexed by column
//     from shared memory. Padded q rows (at or past S) are masked out of P
//     before the exponential can meet them.
//   * register budget: at D = 256 the dQ kernel takes 32-key tiles and the
//     dK/dV kernel computes dK and dV in two 128-column halves (grid z),
//     each half recomputing S^T and dP^T.
// Design (f32, the parity runs): the same passes at 32x32 tiles with plain
// FMA, one key (dQ) or one query (dK/dV) per lane.
// Speed work (wgmma, TMA, pipelining, a fused single pass) is later.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

struct Strides {  // (batch, head, seq) element strides of q, k, v, dO
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ----------------------------------------------------------- bf16 paths
constexpr int kRows = 64;  // rows of the tile a block owns: 16 per warp

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  uint16_t* __restrict__ dq, int H, int S, int Skv, Strides st, int causal,
                  float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* dOs = Qs + kRows * kLd;
  uint16_t* Ks = dOs + kRows * kLd;
  uint16_t* Vs = Ks + BK * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_offset = Skv - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g;  // query row of acc[.][0..1]; [2..3] are r_lo + 8
  const float scale_log2 = scale * kLog2e;

  const uint16_t* kp = k + b * st.kb + h * st.kh;
  const uint16_t* vp = v + b * st.vb + h * st.vh;
  load_tile_bf16<D, kRows>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, S - q0);
  load_tile_bf16<D, kRows>(dOs, dout + b * st.ob + h * st.oh + q0 * st.os, st.os, S - q0);
  float lse2[2], dlt[2];  // this thread's two rows: lse in log2 units, Delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + 8 * i;
    lse2[i] = row < S ? lse[(long long)bh * S + row] * kLog2e : 0.f;
    dlt[i] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }

  const int kv_end = causal ? min(Skv, row_offset + min(q0 + kRows, S)) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, BK>(Ks, kp + k0 * st.ks, st.ks, Skv - k0);
    load_tile_bf16<D, BK>(Vs, vp + k0 * st.vs, st.vs, Skv - k0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BK keys.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ld_a(Qs + (warp * 16 + g) * kLd + kk * 16 + 2 * t, kLd, aq);
      ld_a(dOs + (warp * 16 + g) * kLd + kk * 16 + 2 * t, kLd, ao);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t b0, b1;
        ld_b_nk(Ks + (j * 8 + g) * kLd + kk * 16 + 2 * t, b0, b1);
        mma16816(s[j], aq[0], aq[1], aq[2], aq[3], b0, b1);
        ld_b_nk(Vs + (j * 8 + g) * kLd + kk * 16 + 2 * t, b0, b1);
        mma16816(dp[j], ao[0], ao[1], ao[2], ao[3], b0, b1);
      }
    }

    // dS = P o (dP - Delta) in place of S; mask only diagonal / ragged tiles.
    const bool edge = (k0 + BK > Skv) || (causal && k0 + BK - 1 > row_offset + q0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lse2[e >> 1]);
        if (edge) {
          const int row = r_lo + (e >> 1) * 8;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= Skv || (causal && row + row_offset < col)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dlt[e >> 1]);
      }
    }

    // dQ += dS K: dS (16 x BK) from registers, K (BK x D) as the [k][n] operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], a);
      const uint16_t* kr = Ks + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        ld_b_kn(kr + n * 8, kLd, b0, b1);
        mma16816(acc[n], a[0], a[1], a[2], a[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r_lo + i * 8;
    if (row >= S) continue;
    uint16_t* orow = dq + ((long long)bh * S + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// BQ: q rows per tile of the loop; DN: gradient columns per block (D, or a
// half of D = 256, chosen by blockIdx.z).
template <int D, int BQ, int DN>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int H, int S, int Skv,
                   Strides st, int causal, float scale) {
  constexpr int kLd = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = Ks + kRows * kLd;
  uint16_t* Qs = Vs + kRows * kLd;
  uint16_t* dOs = Qs + BQ * kLd;
  float* Ls = reinterpret_cast<float*>(dOs + BQ * kLd);  // lse (log2 units) of the q tile
  float* Ds = Ls + BQ;                                   // Delta of the q tile

  const int k0 = blockIdx.x * kRows;  // low key tiles see the most queries: launched first
  const int c0 = blockIdx.z * DN;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_offset = Skv - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + warp * 16 + g;  // key of acc[.][0..1]; [2..3] are key_lo + 8
  const float scale_log2 = scale * kLog2e;

  const uint16_t* qp = q + b * st.qb + h * st.qh;
  const uint16_t* op = dout + b * st.ob + h * st.oh;
  load_tile_bf16<D, kRows>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, Skv - k0);
  load_tile_bf16<D, kRows>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, Skv - k0);

  // First q tile whose rows reach key k0: row i sees keys <= i + row_offset.
  const int q_begin = causal ? max(0, k0 - row_offset) / BQ * BQ : 0;

  float dk_acc[DN / 8][4], dv_acc[DN / 8][4];
#pragma unroll
  for (int n = 0; n < DN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = q_begin; q0 < S; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile_bf16<D, BQ>(Qs, qp + q0 * st.qs, st.qs, S - q0);
    load_tile_bf16<D, BQ>(dOs, op + q0 * st.os, st.os, S - q0);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < S;
      Ls[i] = in ? lse[(long long)bh * S + q0 + i] * kLog2e : 0.f;
      Ds[i] = in ? delta[(long long)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ld_a(Ks + (warp * 16 + g) * kLd + kk * 16 + 2 * t, kLd, ak);
      ld_a(Vs + (warp * 16 + g) * kLd + kk * 16 + 2 * t, kLd, av);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t b0, b1;
        ld_b_nk(Qs + (j * 8 + g) * kLd + kk * 16 + 2 * t, b0, b1);
        mma16816(s[j], ak[0], ak[1], ak[2], ak[3], b0, b1);
        ld_b_nk(dOs + (j * 8 + g) * kLd + kk * 16 + 2 * t, b0, b1);
        mma16816(dp[j], av[0], av[1], av[2], av[3], b0, b1);
      }
    }

    // P^T in place of S^T, dS^T = P^T o (dP^T - Delta) in place of dP^T.
    // Edge tiles: the causal diagonal, ragged keys, and padded q rows
    // (their lse is not the row's: exp could overflow, and inf * 0 = NaN).
    const bool edge = (q0 + BQ > S) || (k0 + kRows > Skv) ||
                      (causal && q0 + row_offset < k0 + kRows - 1);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - Ls[qi]);
        if (edge) {
          const int key = key_lo + (e >> 1) * 8;
          const int row = q0 + qi;
          if (row >= S || key >= Skv || (causal && row + row_offset < key)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Ds[qi]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over this block's DN columns; dO and Q
    // are the [k][n] operands.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ad[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], ap);
      acc_to_a(dp[2 * kk], dp[2 * kk + 1], ad);
      const uint16_t* orow = dOs + (kk * 16 + 2 * t) * kLd + c0 + g;
      const uint16_t* qrow = Qs + (kk * 16 + 2 * t) * kLd + c0 + g;
#pragma unroll
      for (int n = 0; n < DN / 8; ++n) {
        uint32_t b0, b1;
        ld_b_kn(orow + n * 8, kLd, b0, b1);
        mma16816(dv_acc[n], ap[0], ap[1], ap[2], ap[3], b0, b1);
        ld_b_kn(qrow + n * 8, kLd, b0, b1);
        mma16816(dk_acc[n], ad[0], ad[1], ad[2], ad[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + i * 8;
    if (key >= Skv) continue;
    const long long off = ((long long)bh * Skv + key) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          pack_bf16(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ f32 paths
constexpr int kT32 = 32;  // rows per block and per tile: 8 rows per warp, one column per lane

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int H, int S, int Skv, Strides st, int causal,
                 float scale) {
  constexpr int kU = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [32][D], read by row (broadcast)
  float* dOs = Qs + kT32 * D;                   // [32][D]
  float* Ks = dOs + kT32 * D;                   // [32][D + 1]: conflict-free column reads
  float* Vs = Ks + kT32 * (D + 1);              // [32][D + 1]
  float* Ps = Vs + kT32 * (D + 1);              // [4 warps][8 rows][32 keys]: dS

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_offset = Skv - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Pw = Ps + warp * 8 * 32;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  load_tile_f32<D, kT32, D>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, S - q0);
  load_tile_f32<D, kT32, D>(dOs, dout + b * st.ob + h * st.oh + q0 * st.os, st.os, S - q0);
  float lse_r[8], dlt[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    lse_r[i] = row < S ? lse[(long long)bh * S + row] : 0.f;
    dlt[i] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }

  const int kv_end = causal ? min(Skv, row_offset + min(q0 + kT32, S)) : Skv;
  const int n_tiles = (kv_end + kT32 - 1) / kT32;
  float acc[8][kU];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kT32;
    __syncthreads();
    load_tile_f32<D, kT32, D + 1>(Ks, kp + k0 * st.ks, st.ks, Skv - k0);
    load_tile_f32<D, kT32, D + 1>(Vs, vp + k0 * st.vs, st.vs, Skv - k0);
    __syncthreads();

    // Lane owns key k0 + lane: s[i] and dp[i] against query row i.
    float s[8], dp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
    const float* krow = Ks + lane * (D + 1);
    const float* vrow = Vs + lane * (D + 1);
    const float* qw = Qs + warp * 8 * D;
    const float* ow = dOs + warp * 8 * D;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] = fmaf(qw[i * D + d], kd, s[i]);
        dp[i] = fmaf(ow[i * D + d], vd, dp[i]);
      }
    }
    const int col = k0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + warp * 8 + i;
      float p = expf(s[i] * scale - lse_r[i]);
      if (col >= Skv || (causal && row + row_offset < col)) p = 0.f;
      Pw[i * 32 + lane] = p * (dp[i] - dlt[i]);
    }
    __syncwarp();
    for (int j = 0; j < kT32; ++j) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float kj = Ks[j * (D + 1) + lane + 32 * u];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][u] = fmaf(Pw[i * 32 + j], kj, acc[i][u]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    if (row >= S) continue;
    float* orow = dq + ((long long)bh * S + row) * D;
#pragma unroll
    for (int u = 0; u < kU; ++u) orow[lane + 32 * u] = acc[i][u] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int H, int S, int Skv,
                  Strides st, int causal, float scale) {
  constexpr int kU = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [32][D], read by row (broadcast)
  float* Vs = Ks + kT32 * D;                    // [32][D]
  float* Qs = Vs + kT32 * D;                    // [32][D + 1]
  float* dOs = Qs + kT32 * (D + 1);             // [32][D + 1]
  float* Ls = dOs + kT32 * (D + 1);             // [32] lse of the q tile
  float* Ds = Ls + kT32;                        // [32] Delta of the q tile
  float* Ps = Ds + kT32;                        // [4 warps][8 keys][32 queries]: P^T
  float* dSs = Ps + kWarps * 8 * 32;            // the same for dS^T

  const int k0 = blockIdx.x * kT32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row_offset = Skv - S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Pw = Ps + warp * 8 * 32;
  float* dSw = dSs + warp * 8 * 32;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* op = dout + b * st.ob + h * st.oh;
  load_tile_f32<D, kT32, D>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, Skv - k0);
  load_tile_f32<D, kT32, D>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, Skv - k0);

  const int q_begin = causal ? max(0, k0 - row_offset) / kT32 * kT32 : 0;
  float dk_acc[8][kU], dv_acc[8][kU];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) dk_acc[i][u] = dv_acc[i][u] = 0.f;

  for (int q0 = q_begin; q0 < S; q0 += kT32) {
    __syncthreads();
    load_tile_f32<D, kT32, D + 1>(Qs, qp + q0 * st.qs, st.qs, S - q0);
    load_tile_f32<D, kT32, D + 1>(dOs, op + q0 * st.os, st.os, S - q0);
    if (threadIdx.x < kT32) {
      const bool in = q0 + threadIdx.x < S;
      Ls[threadIdx.x] = in ? lse[(long long)bh * S + q0 + threadIdx.x] : 0.f;
      Ds[threadIdx.x] = in ? delta[(long long)bh * S + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    // Lane owns query row q0 + lane: s[i] and dp[i] against key i of the warp.
    float s[8], dp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = dp[i] = 0.f;
    const float* qrow = Qs + lane * (D + 1);
    const float* orow = dOs + lane * (D + 1);
    const float* kw = Ks + warp * 8 * D;
    const float* vw = Vs + warp * 8 * D;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], od = orow[d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] = fmaf(kw[i * D + d], qd, s[i]);
        dp[i] = fmaf(vw[i * D + d], od, dp[i]);
      }
    }
    const int row = q0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = k0 + warp * 8 + i;
      float p = expf(s[i] * scale - Ls[lane]);
      if (row >= S || key >= Skv || (causal && row + row_offset < key)) p = 0.f;
      Pw[i * 32 + lane] = p;
      dSw[i * 32 + lane] = p * (dp[i] - Ds[lane]);
    }
    __syncwarp();
    for (int j = 0; j < kT32; ++j) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float oj = dOs[j * (D + 1) + lane + 32 * u];
        const float qj = Qs[j * (D + 1) + lane + 32 * u];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dv_acc[i][u] = fmaf(Pw[i * 32 + j], oj, dv_acc[i][u]);
          dk_acc[i][u] = fmaf(dSw[i * 32 + j], qj, dk_acc[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + warp * 8 + i;
    if (key >= Skv) continue;
    const long long off = ((long long)bh * Skv + key) * D;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      dk[off + lane + 32 * u] = dk_acc[i][u] * scale;
      dv[off + lane + 32 * u] = dv_acc[i][u];
    }
  }
}

// ------------------------------------------------------------- launches
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, H, S, Skv;
  Strides st;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, int dtype) {
  cudaError_t err;
  if (dtype == 1) {
    constexpr int BK = D == 256 ? 32 : 64;
    const size_t smem = size_t(2 * kRows + 2 * BK) * (D + kPad) * sizeof(uint16_t);
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dq_bf16<D, BK>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
    flash_bwd_dq_bf16<D, BK><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
        static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout), a.lse, a.delta,
        static_cast<uint16_t*>(dq), a.H, a.S, a.Skv, a.st, a.causal, a.scale);
  } else {
    const size_t smem =
        (size_t(2 * kT32) * D + size_t(2 * kT32) * (D + 1) + kWarps * 8 * 32) * sizeof(float);
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dq_f32<D>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((a.S + kT32 - 1) / kT32, a.B * a.H);
    flash_bwd_dq_f32<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dq), a.H, a.S, a.Skv, a.st, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, int dtype) {
  cudaError_t err;
  if (dtype == 1) {
    constexpr int BQ = D >= 128 ? 32 : 64;
    constexpr int DN = D > 128 ? 128 : D;
    const size_t smem =
        size_t(2 * kRows + 2 * BQ) * (D + kPad) * sizeof(uint16_t) + 2 * BQ * sizeof(float);
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dkv_bf16<D, BQ, DN>, smem, configured)) != cudaSuccess)
      return err;
    const dim3 grid((a.Skv + kRows - 1) / kRows, a.B * a.H, D / DN);
    flash_bwd_dkv_bf16<D, BQ, DN><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
        static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout), a.lse, a.delta,
        static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), a.H, a.S, a.Skv, a.st, a.causal,
        a.scale);
  } else {
    const size_t smem = (size_t(2 * kT32) * D + size_t(2 * kT32) * (D + 1) + 2 * kT32 +
                         2 * kWarps * 8 * 32) * sizeof(float);
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dkv_f32<D>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((a.Skv + kT32 - 1) / kT32, a.B * a.H);
    flash_bwd_dkv_f32<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.S, a.Skv, a.st, a.causal,
        a.scale);
  }
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int B, int H, int S, int Skv, long long sqb, long long sqh,
               long long sqs, long long skb, long long skh, long long sks, long long svb,
               long long svh, long long svs, long long sob, long long soh, long long sos,
               int causal, float scale, void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              B, H, S, Skv, Strides{sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos},
              causal, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Both return a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16.
// q, dO are [B, H, S, D] and k, v [B, H, Skv, D] with unit stride along D and
// the given (batch, head, seq) element strides; lse (natural log) and Delta
// are contiguous [B*H, S] f32; dq, dk, dv are contiguous [B, H, S|Skv, D].
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int H, int S,
                               int Skv, int D, long long sqb, long long sqh, long long sqs,
                               long long skb, long long skh, long long sks, long long svb,
                               long long svh, long long svs, long long sob, long long soh,
                               long long sos, int causal, float scale, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, S, Skv, sqb, sqh, sqs, skb, skh, sks,
                           svb, svh, svs, sob, soh, sos, causal, scale, stream);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 32: return int(launch_dq<32>(a, dq, dtype));
    case 64: return int(launch_dq<64>(a, dq, dtype));
    case 128: return int(launch_dq<128>(a, dq, dtype));
    case 256: return int(launch_dq<256>(a, dq, dtype));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int B,
                                int H, int S, int Skv, int D, long long sqb, long long sqh,
                                long long sqs, long long skb, long long skh, long long sks,
                                long long svb, long long svh, long long svs, long long sob,
                                long long soh, long long sos, int causal, float scale, int dtype,
                                void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, S, Skv, sqb, sqh, sqs, skb, skh, sks,
                           svb, svh, svs, sob, soh, sos, causal, scale, stream);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 32: return int(launch_dkv<32>(a, dk, dv, dtype));
    case 64: return int(launch_dkv<64>(a, dk, dv, dtype));
    case 128: return int(launch_dkv<128>(a, dk, dv, dtype));
    case 256: return int(launch_dkv<256>(a, dk, dv, dtype));
    default: return int(cudaErrorInvalidValue);
  }
}
