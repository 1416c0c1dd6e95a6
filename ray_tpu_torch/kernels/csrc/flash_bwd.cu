// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dQ (which also computes Delta) and dK/dV.
//
// Replaces: ray_tpu/ops/attention.py `_flash_bwd_pallas`, whose two
// pallas_calls run `_flash_bwd_dq_kernel` (dQ over q blocks, streaming k
// blocks up to the causal diagonal) and `_flash_bwd_dkv_kernel` (dK/dV over
// k blocks, streaming q blocks from the first one that reaches the
// diagonal), and the Delta = rowsum(dO o O) the reference computes before
// them. FlashAttention-2 arithmetic against the forward's saved lse:
//   P  = exp(S*scale - lse), masked to 0;      dP = dO V^T;
//   dS = P o (dP - Delta);
//   dQ = scale * dS K;  dK = scale * dS^T Q;  dV = P^T dO,
// with dS rounded to the input dtype before its products and P rounded to
// dO's dtype before P^T dO, as the reference rounds them.
//
// Bound on the H100: per unmasked (query, key) pair the dQ kernel does
// 6*D FLOPs (S, dP, dS K) and the dK/dV kernel 8*D (S^T, dP^T, P^T dO,
// dS^T Q), against q, k, v, o, dO read once and the gradients written once:
// at the training shape (S = 1024, D = 64, bf16, causal) both are bound by
// tensor-core operations, just above the bytes. The two passes keep the
// reference's split: no atomics, every gradient is deterministic; S and dP
// are recomputed in each pass (a fused pass would do 10*D FLOPs per pair,
// with dQ summed by atomics in an order that changes from run to run).
//
// Design (bf16), the forward's (flash_fwd.cu) carried over:
//   * warp specialisation: one producer warp issues TMA copies into a ring
//     of shared-memory stages with full / empty mbarriers per stage and gives
//     its registers up (setmaxnreg); two consumer warpgroups of 64 outer rows
//     each take turns, in a ring of named barriers, at issuing their wgmma
//     products, so the tensor cores run one warpgroup's products while the
//     other computes its exponentials and dS; within a warpgroup the products
//     of tile j (S, dP) are issued with the gradient products of tile j - 1,
//     which run while tile j's P and dS are computed;
//   * dQ: a work item is 128 q rows (64 at D = 256, one warpgroup: Q, dO and
//     O of 128 rows do not fit beside a ring). Q, dO and O are loaded once;
//     the prologue computes Delta of each row from the O and dO tiles in
//     shared memory (the four threads of a quad that hold a row in the
//     accumulator layout sum a quarter of it each) and writes it out for the
//     dK/dV kernel. K and V tiles of 64 keys (32 at D = 256) stream up to the
//     causal diagonal. S = Q K^T and dP = dO V^T are SS products with both
//     operands K-major; dS is formed in S's accumulators, and rounded in
//     pairs those are the A fragments of dQ += dS K, an RS product with K as
//     the MN-major B (the transpose bit), as P V in the forward;
//   * dK/dV: a work item is 128 keys; K and V are loaded once, Q and dO tiles
//     of 64 q rows (32 at D >= 128) stream from the first that reaches the
//     diagonal, with the tile's lse and Delta, copied by a second producer
//     warp (cp.async, completion on the stage's mbarrier) into a layout that
//     puts the four values thread q of a quad reads for columns 8j + 2q and
//     8j + 2q + 1 into one conflict-free 16-byte word. S^T = K Q^T and
//     dP^T = V dO^T are SS products with K and V as the A operands, so the
//     accumulators of P^T and dS^T are the A fragments of dV += P^T dO and
//     dK += dS^T Q, RS products with dO and Q as the MN-major B. At D = 256
//     dK and dV (64 x 256 f32 each) do not fit a thread's registers: each
//     item computes one 128-column half (two items per key tile, each
//     recomputing S^T and dP^T);
//   * masks only on diagonal and ragged tiles; padded q rows are masked out
//     of P before it meets anything (their lse is 0, not the row's); a
//     warpgroup skips the products of tiles it has no pair in (an empty
//     turn keeps the ring in step);
//   * persistent CTAs walk a static list of work items, heaviest causal
//     tiles first (late q tiles for dQ, early key tiles for dK/dV);
//   * epilogue: the scale applied, bf16, through a swizzled shared-memory
//     tile and one TMA store per column block at D <= 128; stored directly
//     by the threads at D = 256 (no room) and for a dQ warpgroup whose rows
//     start before row 0 (a TMA store takes no negative coordinate).
// The products must not be serialised by ptxas (C7513): every register a
// wgmma reads is defined before the wgmma.fence and kept alive until the
// wgmma.wait_group that retires it (reg_fence on dS, P^T, dS^T and the
// accumulators), and descriptors are uniform base descriptors plus
// compile-time offsets. chip_smoke.py fails the build if ptxas serialises
// them or spills.
// The launch plan is Python's (`flash_bwd.launches`, tested on the CPU): the
// stages, shared memory, grid, the work items in launch order with the
// stream tiles each warpgroup reads (a __grid_constant__ table), and the
// tensor maps (rank 4 over [B, H, L, D] with the tensors' own byte strides,
// so a strided dO from autograd is read in place). This file computes none
// of them; it refuses a plan whose tile shape is not the one an
// instantiation was compiled for.
// Design (f32, the parity runs): 32x32 tiles with plain FMA, one key (dQ) or
// one query (dK/dV) per lane; the dQ kernel computes Delta the same way.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// ------------------------------------------------------------ bf16 path
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;   // dynamic shared memory one block may use
constexpr int kMaxTiles = 128;     // outer tiles per head a plan may list
constexpr int kTurnThreads = 256;  // a turn's barrier: the warpgroup waiting and the one handing over
constexpr int kProducerRegs = 40;  // setmaxnreg with two consumer warpgroups:
constexpr int kConsumerRegs = 232; // 128 * 40 + 256 * 232 <= 65536

// Shapes shared by both kernels: swizzle and TMA box of a head dim.
template <int D>
struct Box {
  static constexpr int SW = D == 32 ? 64 : 128;  // bytes of one shared row of a box
  static constexpr int COLS = SW / 2;            // bf16 columns of one box
  static constexpr bool STAGE_OUT = D <= 128;    // gradients stored through shared memory and TMA
};

template <int D>
struct DqCfg : Box<D> {
  static constexpr int NWG = D == 256 ? 1 : 2;      // consumer warpgroups of 64 q rows
  static constexpr int BQ = 64 * NWG;               // q rows per work item
  static constexpr int BK = D == 256 ? 32 : 64;     // keys per streamed tile
  static constexpr int THREADS = 128 * (NWG + 1);   // and the producer warpgroup
  static constexpr int CONSUMERS = 128 * NWG;       // arrivals that release a stage or the item's tiles
  static constexpr int Q_BYTES = BQ * D * 2;        // each of Q, dO, O
  static constexpr int KV_BYTES = BK * D * 2;       // each of K, V in a stage
  static constexpr int OUT_BYTES = Box<D>::STAGE_OUT ? BQ * D * 2 : 0;
  static constexpr int smem_bytes(int stages) {
    return 1024 + 3 * Q_BYTES + OUT_BYTES + 2 * stages * KV_BYTES + 8 * (2 * stages + 2);
  }
};

template <int D>
struct DkvCfg : Box<D> {
  static constexpr int NWG = 2;                     // consumer warpgroups of 64 keys
  static constexpr int BKV = 64 * NWG;              // keys per work item
  static constexpr int BQ = D <= 64 ? 64 : 32;      // q rows per streamed tile
  static constexpr int SPLITS = D == 256 ? 2 : 1;   // column halves of dK and dV
  static constexpr int DN = D / SPLITS;             // gradient columns per item
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int KV_BYTES = BKV * D * 2;      // each of K, V
  static constexpr int QT_BYTES = BQ * D * 2;       // each of Q, dO in a stage
  static constexpr int STATS_BYTES = BQ * 8;        // lse and Delta of a stage's q rows
  static constexpr int OUT_BYTES = Box<D>::STAGE_OUT ? 2 * BKV * D * 2 : 0;  // dK and dV
  static constexpr int smem_bytes(int stages) {
    return 1024 + 2 * KV_BYTES + OUT_BYTES + stages * (2 * QT_BYTES + STATS_BYTES) + 8 * (2 * stages + 2);
  }
};

// One outer tile of a head, as the plan lists them in launch order: its
// first row (q rows for dQ, negative for a ragged first tile; keys for
// dK/dV), the stream tiles [lo, hi) the producer loads for it, and the range
// [wg_lo[c], wg_hi[c]) consumer warpgroup c reads (empty for a warpgroup
// without a real row). (flash_bwd.Tile / _Tile in Python.)
struct Tile {
  int r0;
  unsigned short lo, hi;
  unsigned short wg_lo[2], wg_hi[2];
};
struct Tiles {
  Tile t[kMaxTiles];
};

// What rt_flash_bwd_dq and rt_flash_bwd_dkv are handed for a bf16 launch
// (flash_bwd.LaunchPlan). Work item i is tile i / (BH * splits) of head
// (i % (BH * splits)) / splits, column split i % splits.
struct BwdLaunch {
  int block_rows, block_stream, swizzle, stages, smem_bytes, grid, n_items, BH, splits, warpgroups;
  TmaSpec maps[6];  // dQ: q, dO, o, k, v, dq; dK/dV: q, dO, k, v, dk, dv
  Tiles tiles;
};

// This thread's rows and columns in a consumer warpgroup's accumulators.
struct Rows {
  int first;  // the warpgroup's first outer row
  int lo;     // row of acc[4j], acc[4j + 1]; acc[4j + 2], acc[4j + 3] are row lo + 8
  int col;    // column of acc[4j] within its 8-column group
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// d (64 x N) = A B^T over a reduction of K: A is 64 rows of a tile of A_ROWS
// rows, B a tile of N rows, both K-major in swizzled shared memory. Issues
// only. The descriptors are the tiles' base descriptors plus compile-time
// offsets (the address field is addr >> 4 in the low bits; tiles lie below
// 256 KB, so the sum never carries out of it): no per-thread arithmetic
// between the products, which would make ptxas serialise them.
template <int N, int K, int SW, int A_ROWS>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint64_t a_desc, uint64_t b_desc) {
  constexpr int KPB = SW / 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t col = kk / KPB, in_block = (kk % KPB) * 32;
    Wgmma<N>::ss(d, a_desc + ((col * A_ROWS * SW + in_block) >> 4),
                 b_desc + ((col * N * SW + in_block) >> 4), kk > 0);
  }
}

// d (64 x N) += A B: A (64 x K, bf16) from registers, B (K x N) MN-major
// from swizzled shared memory (the transpose bit). Issues only.
template <int N, int K, int SW>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2], const uint32_t (&a)[K / 16][4], uint64_t b_desc) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) Wgmma<N>::template rs<1>(d, a[kk], b_desc + ((kk * 16 * SW) >> 4), 1);
}

// Accumulators rounded to bf16 in pairs: the accumulators 8i .. 8i + 7 of a
// product are the A fragment of its 16-column slice i.
template <int N>
__device__ __forceinline__ void pack(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = pack_bf16(s[8 * i + 2 * e], s[8 * i + 2 * e + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// The consumer warpgroups take turns, in a ring, at issuing their products
// (named barriers 1 .. NWG). Warpgroup c waits for its turn on barrier
// 1 + c; ending a turn lets the next one go. One warpgroup takes no turns.
template <int NWG>
__device__ __forceinline__ void turn_begin(int c) {
  if constexpr (NWG > 1) named_bar_sync(1 + c, kTurnThreads);
}
template <int NWG>
__device__ __forceinline__ void turn_end(int c) {
  if constexpr (NWG > 1) named_bar_arrive(1 + (c + 1) % NWG, kTurnThreads);
}

// A stream tile this warpgroup has no pair in: wait for it, take the turn
// its products would have taken, and hand the stage back.
template <int NWG>
__device__ __forceinline__ void empty_turn(int c, uint64_t* full, uint64_t* empty, int& stage,
                                           uint32_t& phase, int stages) {
  mbar_wait(full + stage, phase);
  turn_begin<NWG>(c);
  turn_end<NWG>(c);
  mbar_arrive(empty + stage);
  if (++stage == stages) stage = 0, phase ^= 1;
}

// Sum over 8 bf16 pairs of a * b, in f32.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), s);
    s = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), s);
  }
  return s;
}

// This thread's quarter of rowsum(a o b) for row r of two tiles of ROWS rows
// laid out as TMA lands them (column blocks, swizzled): the 16-byte chunks
// qd, qd + 4, ... of the row.
template <int D, int ROWS>
__device__ __forceinline__ float row_dot_quarter(const unsigned char* a, const unsigned char* b, int r, int qd) {
  constexpr int SW = Box<D>::SW, CPB = SW / 16;  // 16-byte chunks per row of a column block
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int ch = qd + 4 * i;
    const uint32_t off = (ch / CPB) * ROWS * SW + swizzled(r * SW + (ch % CPB) * 16, SW);
    s += dot8(*reinterpret_cast<const uint4*>(a + off), *reinterpret_cast<const uint4*>(b + off));
  }
  return s;
}

// dS = P o (dP - Delta) of one key tile in S's accumulators (rows: q rows,
// columns: keys), P = exp(S*scale - lse) masked to 0 (diagonal and
// ragged-tail tiles only).
template <int BK>
__device__ __forceinline__ void ds_tile(float (&s)[BK / 2], const float (&dp)[BK / 2], const float (&lse2)[2],
                                        const float (&dlt)[2], const Rows& rows, int k0, int S, int Skv,
                                        int causal, float scale_log2) {
  const int row_offset = Skv - S;
  const bool edge = (k0 + BK > Skv) || (causal && k0 + BK - 1 > row_offset + rows.first);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -lse2[i]));
      if (edge) {
        const int row = rows.lo + 8 * i, col = k0 + 8 * j + rows.col + (e & 1);
        if (col >= Skv || (causal && row + row_offset < col)) p = 0.f;
      }
      s[4 * j + e] = p * (dp[4 * j + e] - dlt[i]);
    }
  }
}

// P^T (in s) and dS^T = P^T o (dP^T - Delta) (in dp) of one q tile in the
// accumulators of S^T and dP^T (rows: keys, columns: q rows). stats holds
// the tile's lse and Delta, float4 4j + q = {lse of columns 8j + 2q, +1;
// Delta of the same}. Padded q rows (past S: zero-filled, lse 0) are masked
// out of P with the diagonal.
template <int BQ>
__device__ __forceinline__ void ds_tile_t(float (&s)[BQ / 2], float (&dp)[BQ / 2], const float4* stats,
                                         const Rows& keys, int q0, int S, int Skv, int causal, float scale_log2) {
  const int row_offset = Skv - S;
  const bool edge = (q0 + BQ > S) || (keys.first + 64 > Skv) || (causal && q0 + row_offset < keys.first + 63);
  const int qd = keys.col / 2;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float4 st = stats[4 * j + qd];
    const float l2[2] = {st.x * kLog2e, st.y * kLog2e}, dl[2] = {st.z, st.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -l2[e & 1]));
      if (edge) {
        const int key = keys.lo + 8 * (e >> 1), row = q0 + 8 * j + keys.col + (e & 1);
        if (row >= S || key >= Skv || (causal && row + row_offset < key)) p = 0.f;
      }
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - dl[e & 1]);
    }
  }
}

// Writes 64 rows x N columns of acc * scale, bf16, into a warpgroup's
// staging tile laid out as a TMA box of 64 rows (column blocks, swizzled:
// conflict-free 4-byte writes).
template <int N, int SW>
__device__ __forceinline__ void stage_out(unsigned char* out, const float (&acc)[N / 2], float scale, int warp,
                                          int lane) {
  constexpr int BOX = SW / 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = warp * 16 + (lane >> 2) + 8 * i;  // row within the warpgroup's 64
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int cb = j / (BOX / 8), chunk = j % (BOX / 8);
      const uint32_t off = swizzled(rl * SW + chunk * 16 + (lane & 3) * 4, SW);
      *reinterpret_cast<uint32_t*>(out + cb * 64 * SW + off) =
          pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// Row `row` of this thread (acc[4j + 2i], acc[4j + 2i + 1]) times scale,
// bf16, stored directly at dst (the row's first of its N columns).
template <int N>
__device__ __forceinline__ void store_row(uint16_t* dst, const float (&acc)[N / 2], int i, int col, float scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + j * 8 + col) =
        pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
}

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_dq,
                  uint16_t* __restrict__ dq, const float* __restrict__ lse, float* __restrict__ delta,
                  const __grid_constant__ Tiles tiles, int H, int S, int Skv, int causal, float scale,
                  int n_items, int BH, int stages) {
  using C = DqCfg<D>;
  constexpr int BK = C::BK, SW = C::SW, NWG = C::NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + C::Q_BYTES;
  unsigned char* Os = dOs + C::Q_BYTES;
  unsigned char* Outs = Os + C::Q_BYTES;  // dQ staging, 64 rows per consumer warpgroup
  unsigned char* Ks = Outs + C::OUT_BYTES;
  unsigned char* Vs = Ks + stages * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + stages * C::KV_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;  // Q, dO and O of the item
  uint64_t* q_empty = q_full + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, C::CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, C::CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    if constexpr (NWG > 1) regs_release<kProducerRegs>();
    if (threadIdx.x == 0) {
      const CUtensorMap* item_maps[3] = {&tm_q, &tm_do, &tm_o};
      for (const CUtensorMap* m : item_maps) tma_prefetch_desc(m);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      tma_prefetch_desc(&tm_dq);
      int stage = 0;
      uint32_t phase = 0;
      int n = 0;  // work items done by this CTA
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const Tile& tile = tiles.t[item / BH];
        const int bh = item % BH, b = bh / H, h = bh % H;
        mbar_wait(q_empty, (n & 1) ^ 1);  // the consumers are done with the last item's tiles
        mbar_arrive_expect_tx(q_full, 3 * C::Q_BYTES);
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int cb = 0; cb < D / C::COLS; ++cb)
            tma_load_4d(Qs + t * C::Q_BYTES + cb * C::BQ * SW, item_maps[t], q_full, cb * C::COLS, tile.r0, h, b);
        for (int kt = tile.lo; kt < tile.hi; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_arrive_expect_tx(full + stage, 2 * C::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / C::COLS; ++cb) {
            tma_load_4d(Ks + stage * C::KV_BYTES + cb * BK * SW, &tm_k, full + stage, cb * C::COLS, kt * BK, h, b);
            tma_load_4d(Vs + stage * C::KV_BYTES + cb * BK * SW, &tm_v, full + stage, cb * C::COLS, kt * BK, h, b);
          }
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    if constexpr (NWG > 1) regs_claim<kConsumerRegs>();
    // Consumer warpgroup c takes q rows 64c .. 64c + 63 of the item. The
    // shuffle makes c (and so every descriptor) warp-uniform to the compiler.
    const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, qd = lane & 3;
    const uint64_t q_desc = wgmma_desc(smem_addr(Qs) + c * 64 * SW, 16, 8 * SW, SW);
    const uint64_t do_desc = wgmma_desc(smem_addr(dOs) + c * 64 * SW, 16, 8 * SW, SW);
    const uint32_t k_smem = smem_addr(Ks), v_smem = smem_addr(Vs);
    // Stage st's K and V as the K-major B of S and dP, and K as the MN-major
    // B of dS K.
    auto k_desc = [&](int st) { return wgmma_desc(k_smem + st * C::KV_BYTES, 16, 8 * SW, SW); };
    auto v_desc = [&](int st) { return wgmma_desc(v_smem + st * C::KV_BYTES, 16, 8 * SW, SW); };
    auto kn_desc = [&](int st) { return wgmma_desc(k_smem + st * C::KV_BYTES, BK * SW, 8 * SW, SW); };
    const float scale_log2 = scale * kLog2e;
    int stage = 0;
    uint32_t phase = 0;
    int n = 0;
    if (c == NWG - 1) turn_end<NWG>(c);  // warpgroup 0 takes the first turn
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const Tile& tile = tiles.t[item / BH];
      const int bh = item % BH;
      Rows rows;
      rows.first = tile.r0 + 64 * c;
      rows.lo = rows.first + warp * 16 + (lane >> 2);
      rows.col = 2 * qd;
      float lse2[2];  // lse of this thread's rows in log2 units (0 for padding rows)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rows.lo + 8 * i;
        lse2[i] = (row >= 0 && row < S) ? lse[(long long)bh * S + row] * kLog2e : 0.f;
      }
      float acc[D / 2];
      zero(acc);
      mbar_wait(q_full, n & 1);

      // Delta = rowsum(dO o O) in f32 from the tiles in shared memory: each
      // thread of a quad a quarter of the quad's two rows.
      float dlt[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 64 * c + warp * 16 + (lane >> 2) + 8 * i;  // row within the item's tiles
        dlt[i] = row_dot_quarter<D, C::BQ>(dOs, Os, r, qd);
        dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 1);
        dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 2);
        const int row = rows.lo + 8 * i;
        if (qd == 0 && row >= 0 && row < S) delta[(long long)bh * S + row] = dlt[i];
      }

      const int lo = tile.lo, hi = tile.hi, wlo = tile.wg_lo[c], whi = tile.wg_hi[c];
      int kt = lo;
      if (wlo < whi) {
        for (; kt < wlo; ++kt) empty_turn<NWG>(c, full, empty, stage, phase, stages);
        // Software pipeline: while dQ += dS_{j-1} K_{j-1} runs on the tensor
        // cores, this warpgroup computes dS_j on its ALUs.
        float s[BK / 2], dp[BK / 2];
        uint32_t ds[BK / 16][4];
        mbar_wait(full + stage, phase);
        turn_begin<NWG>(c);
        wgmma_fence();
        issue_ss<BK, D, SW, C::BQ>(s, q_desc, k_desc(stage));
        issue_ss<BK, D, SW, C::BQ>(dp, do_desc, v_desc(stage));
        wgmma_commit();
        turn_end<NWG>(c);
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        if (whi - wlo == 1) mbar_arrive(q_empty);  // the last read of this item's Q and dO is done
        ds_tile<BK>(s, dp, lse2, dlt, rows, kt * BK, S, Skv, causal, scale_log2);
        pack<BK>(s, ds);
        for (++kt; kt < whi; ++kt) {
          const int prev = stage;
          if (++stage == stages) stage = 0, phase ^= 1;
          mbar_wait(full + stage, phase);
          const uint64_t kd = k_desc(stage), vd = v_desc(stage), kn = kn_desc(prev);
          turn_begin<NWG>(c);
          reg_fence(acc);
          wgmma_fence();
          issue_ss<BK, D, SW, C::BQ>(s, q_desc, kd);
          issue_ss<BK, D, SW, C::BQ>(dp, do_desc, vd);
          wgmma_commit();
          issue_rs<D, BK, SW>(acc, ds, kn);
          wgmma_commit();
          turn_end<NWG>(c);
          wgmma_wait<1>();  // S_j and dP_j are in; dS_{j-1} K_{j-1} may still run
          reg_fence(s);
          reg_fence(dp);
          if (kt == whi - 1) mbar_arrive(q_empty);
          ds_tile<BK>(s, dp, lse2, dlt, rows, kt * BK, S, Skv, causal, scale_log2);
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(ds);
          mbar_arrive(empty + prev);  // stage prev's K and V are free again
          pack<BK>(s, ds);            // dS_{j-1} K_{j-1} no longer reads ds
        }
        const uint64_t kn = kn_desc(stage);
        turn_begin<NWG>(c);
        reg_fence(acc);
        wgmma_fence();
        issue_rs<D, BK, SW>(acc, ds, kn);
        wgmma_commit();
        turn_end<NWG>(c);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(ds);
        mbar_arrive(empty + stage);
        if (++stage == stages) stage = 0, phase ^= 1;
      } else {
        mbar_arrive(q_empty);
        turn_begin<NWG>(c);  // the turn of the first S and dP
        turn_end<NWG>(c);
      }
      for (; kt < hi; ++kt) empty_turn<NWG>(c, full, empty, stage, phase, stages);

      const int b = bh / H, h = bh % H;
      // A TMA store takes no negative coordinate: a warpgroup whose rows
      // start before row 0 (only in a head's first, ragged q tile) stores
      // directly, as every warpgroup does at D = 256.
      const bool tma_out = C::STAGE_OUT && rows.first >= 0;
      if (tma_out) {
        // The previous item's store must have read the staging tile first.
        unsigned char* ob = Outs + c * 64 * D * 2;
        const bool leader = threadIdx.x % 128 == 0;
        if (leader) bulk_wait_read();
        named_bar_sync(1 + NWG + c, 128);
        stage_out<D, SW>(ob, acc, scale, warp, lane);
        fence_async_smem();
        named_bar_sync(1 + NWG + c, 128);
        if (leader && rows.first < S) {
#pragma unroll
          for (int cb = 0; cb < D / C::COLS; ++cb) tma_store_4d(&tm_dq, ob + cb * 64 * SW, cb * C::COLS, rows.first, h, b);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = rows.lo + i * 8;
          if (row >= 0 && row < S) store_row<D>(dq + ((long long)bh * S + row) * D, acc, i, rows.col, scale);
        }
      }
    }
    if (C::STAGE_OUT && threadIdx.x % 128 == 0) bulk_wait_read();  // smem outlives the stores' reads
    if (NWG > 1 && c == 0) turn_begin<NWG>(c);  // the last hand-over: every arrival is matched
  }
}

// cp.async of 4 bytes (src_bytes 4) or of zeros (src_bytes 0) into shared memory.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// One arrival on bar once this thread's cp.async copies so far have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_dk, const __grid_constant__ CUtensorMap tm_dv,
                   uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, const float* __restrict__ lse,
                   const float* __restrict__ delta, const __grid_constant__ Tiles tiles, int H, int S,
                   int Skv, int causal, float scale, int n_items, int BH, int stages) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, SW = C::SW, NWG = C::NWG, DN = C::DN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Outs = Vs + C::KV_BYTES;  // dK then dV staging, 64 keys per consumer warpgroup each
  unsigned char* Qs = Outs + C::OUT_BYTES;
  unsigned char* dOs = Qs + stages * C::QT_BYTES;
  float* Stats = reinterpret_cast<float*>(dOs + stages * C::QT_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(Stats) + stages * C::STATS_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* kv_full = empty + stages;  // K and V of the item
  uint64_t* kv_empty = kv_full + 1;
  const int units = BH * C::SPLITS;  // (head, column split) pairs per outer tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA's arrival, and each copying lane's lse and Delta
      mbar_init(empty + s, C::CONSUMERS);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, C::CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    // Warp 0's lane 0 issues the TMA copies, warp 1 copies lse and Delta:
    // split, each thread's state fits the producer's registers.
    regs_release<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_do);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      tma_prefetch_desc(&tm_dk);
      tma_prefetch_desc(&tm_dv);
      int stage = 0;
      uint32_t phase = 0;
      int n = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const Tile& tile = tiles.t[item / units];
        const int bh = (item % units) / C::SPLITS, b = bh / H, h = bh % H;
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / C::COLS; ++cb) {
          tma_load_4d(Ks + cb * C::BKV * SW, &tm_k, kv_full, cb * C::COLS, tile.r0, h, b);
          tma_load_4d(Vs + cb * C::BKV * SW, &tm_v, kv_full, cb * C::COLS, tile.r0, h, b);
        }
        for (int qt = tile.lo; qt < tile.hi; ++qt) {
          mbar_wait(empty + stage, phase ^ 1);
          mbar_arrive_expect_tx(full + stage, 2 * C::QT_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / C::COLS; ++cb) {
            tma_load_4d(Qs + stage * C::QT_BYTES + cb * BQ * SW, &tm_q, full + stage, cb * C::COLS, qt * BQ, h, b);
            tma_load_4d(dOs + stage * C::QT_BYTES + cb * BQ * SW, &tm_do, full + stage, cb * C::COLS, qt * BQ, h, b);
          }
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    } else if (warp == 1) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Tile& tile = tiles.t[item / units];
        const int bh = (item % units) / C::SPLITS;
        const float* lse_h = lse + (long long)bh * S;
        const float* delta_h = delta + (long long)bh * S;
        for (int qt = tile.lo; qt < tile.hi; ++qt) {
          mbar_wait(empty + stage, phase ^ 1);
          // Column i of the tile goes to float4 i / 2: lse in component
          // i % 2, Delta in 2 + i % 2 (zeros past S).
          float* st = Stats + stage * (C::STATS_BYTES / 4);
#pragma unroll
          for (int i = lane; i < BQ; i += 32) {
            const int row = qt * BQ + i, bytes = row < S ? 4 : 0, r = row < S ? row : 0;
            cp_async_4(st + (i / 2) * 4 + (i % 2), lse_h + r, bytes);
            cp_async_4(st + (i / 2) * 4 + 2 + (i % 2), delta_h + r, bytes);
          }
          cp_async_arrive(full + stage);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_claim<kConsumerRegs>();
    // Consumer warpgroup c takes keys 64c .. 64c + 63 of the item.
    const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const uint64_t k_desc = wgmma_desc(smem_addr(Ks) + c * 64 * SW, 16, 8 * SW, SW);
    const uint64_t v_desc = wgmma_desc(smem_addr(Vs) + c * 64 * SW, 16, 8 * SW, SW);
    const uint32_t q_smem = smem_addr(Qs), do_smem = smem_addr(dOs);
    // Stage st's Q and dO as the K-major B of S^T and dP^T, and as the
    // MN-major B of dK and dV (from the first column of this item's split).
    auto q_desc = [&](int st) { return wgmma_desc(q_smem + st * C::QT_BYTES, 16, 8 * SW, SW); };
    auto do_desc = [&](int st) { return wgmma_desc(do_smem + st * C::QT_BYTES, 16, 8 * SW, SW); };
    auto qn_desc = [&](int st, int split) {
      return wgmma_desc(q_smem + st * C::QT_BYTES + split * (DN / C::COLS) * BQ * SW, BQ * SW, 8 * SW, SW);
    };
    auto don_desc = [&](int st, int split) {
      return wgmma_desc(do_smem + st * C::QT_BYTES + split * (DN / C::COLS) * BQ * SW, BQ * SW, 8 * SW, SW);
    };
    const float scale_log2 = scale * kLog2e;
    int stage = 0;
    uint32_t phase = 0;
    int n = 0;
    if (c == NWG - 1) turn_end<NWG>(c);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const Tile& tile = tiles.t[item / units];
      const int bh = (item % units) / C::SPLITS, split = item % C::SPLITS;
      Rows keys;
      keys.first = tile.r0 + 64 * c;
      keys.lo = keys.first + warp * 16 + (lane >> 2);
      keys.col = 2 * (lane & 3);
      float dk_acc[DN / 2], dv_acc[DN / 2];
      zero(dk_acc);
      zero(dv_acc);
      mbar_wait(kv_full, n & 1);

      const int lo = tile.lo, hi = tile.hi, wlo = tile.wg_lo[c], whi = tile.wg_hi[c];
      int qt = lo;
      if (wlo < whi) {
        for (; qt < wlo; ++qt) empty_turn<NWG>(c, full, empty, stage, phase, stages);
        // Software pipeline: while dV += P^T_{j-1} dO_{j-1} and
        // dK += dS^T_{j-1} Q_{j-1} run, this warpgroup computes P^T_j, dS^T_j.
        float s[BQ / 2], dp[BQ / 2];
        uint32_t pt[BQ / 16][4], dsT[BQ / 16][4];  // P^T and dS^T as A fragments
        auto stats = [&](int st) { return reinterpret_cast<const float4*>(Stats + st * (C::STATS_BYTES / 4)); };
        mbar_wait(full + stage, phase);
        turn_begin<NWG>(c);
        wgmma_fence();
        issue_ss<BQ, D, SW, C::BKV>(s, k_desc, q_desc(stage));
        issue_ss<BQ, D, SW, C::BKV>(dp, v_desc, do_desc(stage));
        wgmma_commit();
        turn_end<NWG>(c);
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        if (whi - wlo == 1) mbar_arrive(kv_empty);  // the last read of this item's K and V is done
        ds_tile_t<BQ>(s, dp, stats(stage), keys, qt * BQ, S, Skv, causal, scale_log2);
        pack<BQ>(s, pt);
        pack<BQ>(dp, dsT);
        for (++qt; qt < whi; ++qt) {
          const int prev = stage;
          if (++stage == stages) stage = 0, phase ^= 1;
          mbar_wait(full + stage, phase);
          const uint64_t qd = q_desc(stage), dod = do_desc(stage);
          const uint64_t qn = qn_desc(prev, split), don = don_desc(prev, split);
          turn_begin<NWG>(c);
          reg_fence(dk_acc);
          reg_fence(dv_acc);
          wgmma_fence();
          issue_ss<BQ, D, SW, C::BKV>(s, k_desc, qd);
          issue_ss<BQ, D, SW, C::BKV>(dp, v_desc, dod);
          wgmma_commit();
          issue_rs<DN, BQ, SW>(dv_acc, pt, don);
          issue_rs<DN, BQ, SW>(dk_acc, dsT, qn);
          wgmma_commit();
          turn_end<NWG>(c);
          wgmma_wait<1>();  // S^T_j and dP^T_j are in; the gradient products of j - 1 may still run
          reg_fence(s);
          reg_fence(dp);
          if (qt == whi - 1) mbar_arrive(kv_empty);
          ds_tile_t<BQ>(s, dp, stats(stage), keys, qt * BQ, S, Skv, causal, scale_log2);
          wgmma_wait<0>();
          reg_fence(dk_acc);
          reg_fence(dv_acc);
          reg_fence(pt);
          reg_fence(dsT);
          mbar_arrive(empty + prev);  // stage prev's Q, dO, lse and Delta are free again
          pack<BQ>(s, pt);
          pack<BQ>(dp, dsT);
        }
        const uint64_t qn = qn_desc(stage, split), don = don_desc(stage, split);
        turn_begin<NWG>(c);
        reg_fence(dk_acc);
        reg_fence(dv_acc);
        wgmma_fence();
        issue_rs<DN, BQ, SW>(dv_acc, pt, don);
        issue_rs<DN, BQ, SW>(dk_acc, dsT, qn);
        wgmma_commit();
        turn_end<NWG>(c);
        wgmma_wait<0>();
        reg_fence(dk_acc);
        reg_fence(dv_acc);
        reg_fence(pt);
        reg_fence(dsT);
        mbar_arrive(empty + stage);
        if (++stage == stages) stage = 0, phase ^= 1;
      } else {
        mbar_arrive(kv_empty);
        turn_begin<NWG>(c);  // the turn of the first S^T and dP^T
        turn_end<NWG>(c);
      }
      for (; qt < hi; ++qt) empty_turn<NWG>(c, full, empty, stage, phase, stages);

      if (keys.first >= Skv) continue;  // a ragged tile's keys past the end: nothing to store
      const int b = bh / H, h = bh % H;
      if constexpr (C::STAGE_OUT) {
        unsigned char* ok = Outs + c * 64 * D * 2;
        unsigned char* ov = Outs + C::BKV * D * 2 + c * 64 * D * 2;
        const bool leader = threadIdx.x % 128 == 0;
        if (leader) bulk_wait_read();
        named_bar_sync(1 + NWG + c, 128);
        stage_out<DN, SW>(ok, dk_acc, scale, warp, lane);
        stage_out<DN, SW>(ov, dv_acc, 1.f, warp, lane);
        fence_async_smem();
        named_bar_sync(1 + NWG + c, 128);
        if (leader) {
#pragma unroll
          for (int cb = 0; cb < D / C::COLS; ++cb) {
            tma_store_4d(&tm_dk, ok + cb * 64 * SW, cb * C::COLS, keys.first, h, b);
            tma_store_4d(&tm_dv, ov + cb * 64 * SW, cb * C::COLS, keys.first, h, b);
          }
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = keys.lo + i * 8;
          if (key >= Skv) continue;
          const long long off = ((long long)bh * Skv + key) * D + split * DN;
          store_row<DN>(dk + off, dk_acc, i, keys.col, scale);
          store_row<DN>(dv + off, dv_acc, i, keys.col, 1.f);
        }
      }
    }
    if (C::STAGE_OUT && threadIdx.x % 128 == 0) bulk_wait_read();
    if (c == 0) turn_begin<NWG>(c);
  }
}

// ------------------------------------------------------------ f32 paths
constexpr int kT32 = 32;  // rows per block and per tile: 8 rows per warp, one column per lane

struct Strides {  // (batch, head, seq) element strides of q, k, v, o, dO
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int H, int S, int Skv,
                 Strides st, int causal, float scale) {
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
  const float* op = o + b * st.ob + h * st.oh;
  load_tile_f32<D, kT32, D>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, S - q0);
  load_tile_f32<D, kT32, D>(dOs, dout + b * st.gb + h * st.gh + q0 * st.gs, st.gs, S - q0);
  __syncthreads();
  // Delta = rowsum(dO o O) of this warp's 8 rows: a column per lane, then
  // the warp's sum.
  float lse_r[8], dlt[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + warp * 8 + i;
    float part = 0.f;
    if (row < S) {
#pragma unroll
      for (int u = 0; u < kU; ++u) part = fmaf(dOs[(warp * 8 + i) * D + lane + 32 * u], op[row * st.os + lane + 32 * u], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    dlt[i] = part;
    lse_r[i] = row < S ? lse[(long long)bh * S + row] : 0.f;
    if (lane == 0 && row < S) delta[(long long)bh * S + row] = part;
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
  const float* op = dout + b * st.gb + h * st.gh;
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
    load_tile_f32<D, kT32, D + 1>(dOs, op + q0 * st.gs, st.gs, S - q0);
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
// Refuses a plan this instantiation cannot run: another tile shape,
// swizzle, warpgroup count or split than it was compiled for (the copies'
// expect-tx byte counts and the wgmma shapes assume them), tensor maps that
// are not over these shapes, a ring or table out of range, or too little
// shared memory for its layout.
template <typename C>
bool plan_common_fits(const BwdLaunch& p, int B, int H, int rows, int stream, int splits) {
  return p.block_rows == rows && p.block_stream == stream && p.swizzle == C::SW && p.splits == splits &&
         p.warpgroups == C::NWG && p.stages >= 2 && p.stages <= kMaxStages &&
         p.smem_bytes >= C::smem_bytes(p.stages) && p.smem_bytes <= kMaxSmem && p.grid >= 1 &&
         p.BH == B * H && p.n_items >= p.BH * splits && p.n_items % (p.BH * splits) == 0 &&
         p.n_items / (p.BH * splits) <= kMaxTiles;
}

template <int D>
bool dq_plan_fits(const BwdLaunch& p, int B, int H, int S, int Skv) {
  using C = DqCfg<D>;
  if (!plan_common_fits<C>(p, B, H, C::BQ, C::BK, 1)) return false;
  const int lens[6] = {S, S, S, Skv, Skv, S};
  const unsigned rows[6] = {C::BQ, C::BQ, C::BQ, C::BK, C::BK, 64};
  for (int i = 0; i < 6; ++i)
    if (!map_fits(p.maps[i], D, lens[i], H, B, C::COLS, rows[i])) return false;
  return true;
}

template <int D>
bool dkv_plan_fits(const BwdLaunch& p, int B, int H, int S, int Skv) {
  using C = DkvCfg<D>;
  if (!plan_common_fits<C>(p, B, H, C::BKV, C::BQ, C::SPLITS)) return false;
  const int lens[6] = {S, S, Skv, Skv, Skv, Skv};
  const unsigned rows[6] = {C::BQ, C::BQ, C::BKV, C::BKV, 64, 64};
  for (int i = 0; i < 6; ++i)
    if (!map_fits(p.maps[i], D, lens[i], H, B, C::COLS, rows[i])) return false;
  return true;
}

cudaError_t make_maps(CUtensorMap (&tm)[6], const void* const (&bases)[6], const BwdLaunch& p) {
  cudaError_t err;
  for (int i = 0; i < 6; ++i)
    if ((err = make_map(&tm[i], bases[i], p.maps[i], p.swizzle)) != cudaSuccess) return err;
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;  // written by the dQ kernel, read by the dK/dV kernel
  int B, H, S, Skv;
  Strides st;    // elements (the f32 kernels)
  int causal;
  float scale;
  const BwdLaunch* plan;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, int dtype) {
  cudaError_t err;
  if (dtype == 1) {
    using C = DqCfg<D>;
    if (a.plan == nullptr || !dq_plan_fits<D>(*a.plan, a.B, a.H, a.S, a.Skv)) return cudaErrorInvalidValue;
    const BwdLaunch& p = *a.plan;
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dq_bf16<D>, kMaxSmem, configured)) != cudaSuccess) return err;
    CUtensorMap tm[6];
    if ((err = make_maps(tm, {a.q, a.dout, a.o, a.k, a.v, dq}, p)) != cudaSuccess) return err;
    flash_bwd_dq_bf16<D><<<p.grid, C::THREADS, p.smem_bytes, a.stream>>>(
        tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], static_cast<uint16_t*>(dq), a.lse, a.delta, p.tiles,
        a.H, a.S, a.Skv, a.causal, a.scale, p.n_items, p.BH, p.stages);
  } else {
    const size_t smem =
        (size_t(2 * kT32) * D + size_t(2 * kT32) * (D + 1) + kWarps * 8 * 32) * sizeof(float);
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dq_f32<D>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((a.S + kT32 - 1) / kT32, a.B * a.H);
    flash_bwd_dq_f32<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const float*>(a.o), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dq), a.H, a.S, a.Skv, a.st, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, int dtype) {
  cudaError_t err;
  if (dtype == 1) {
    using C = DkvCfg<D>;
    if (a.plan == nullptr || !dkv_plan_fits<D>(*a.plan, a.B, a.H, a.S, a.Skv)) return cudaErrorInvalidValue;
    const BwdLaunch& p = *a.plan;
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dkv_bf16<D>, kMaxSmem, configured)) != cudaSuccess) return err;
    CUtensorMap tm[6];
    if ((err = make_maps(tm, {a.q, a.dout, a.k, a.v, dk, dv}, p)) != cudaSuccess) return err;
    flash_bwd_dkv_bf16<D><<<p.grid, C::THREADS, p.smem_bytes, a.stream>>>(
        tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
        a.lse, a.delta, p.tiles, a.H, a.S, a.Skv, a.causal, a.scale, p.n_items, p.BH, p.stages);
  } else {
    const size_t smem = (size_t(2 * kT32) * D + size_t(2 * kT32) * (D + 1) + 2 * kT32 +
                         2 * kWarps * 8 * 32) * sizeof(float);
    static bool configured = false;
    if ((err = allow_smem(flash_bwd_dkv_f32<D>, smem, configured)) != cudaSuccess) return err;
    const dim3 grid((a.Skv + kT32 - 1) / kT32, a.B * a.H);
    flash_bwd_dkv_f32<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv),
        a.H, a.S, a.Skv, a.st, a.causal, a.scale);
  }
  return cudaGetLastError();
}

// Byte strides to f32 element strides; false if one is not a whole element.
bool element_strides(const long long (&sb)[15], Strides& st) {
  long long* out[15] = {&st.qb, &st.qh, &st.qs, &st.kb, &st.kh, &st.ks, &st.vb, &st.vh,
                        &st.vs, &st.ob, &st.oh, &st.os, &st.gb, &st.gh, &st.gs};
  for (int i = 0; i < 15; ++i) {
    if (sb[i] % 4 != 0) return false;
    *out[i] = sb[i] / 4;
  }
  return true;
}

template <typename Fn>
int dispatch(int D, int dtype, Fn&& fn) {
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 32: return int(fn(std::integral_constant<int, 32>{}));
    case 64: return int(fn(std::integral_constant<int, 64>{}));
    case 128: return int(fn(std::integral_constant<int, 128>{}));
    case 256: return int(fn(std::integral_constant<int, 256>{}));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both return a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16.
// q, o, dO are [B, H, S, D] and k, v [B, H, Skv, D] with unit stride along D
// and the given (batch, head, seq) strides in BYTES; lse (natural log) and
// Delta are contiguous [B*H, S] f32 (the dQ kernel writes Delta, the dK/dV
// kernel reads it); dq, dk, dv are contiguous [B, H, S|Skv, D]. plan is a
// BwdLaunch (`flash_bwd.launch_plan`) for bf16; the f32 kernels read the
// strides and ignore it (NULL).
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               const void* lse, void* delta, void* dq, int B, int H, int S, int Skv, int D,
                               long long sqb, long long sqh, long long sqs, long long skb, long long skh,
                               long long sks, long long svb, long long svh, long long svs, long long sob,
                               long long soh, long long sos, long long sgb, long long sgh, long long sgs,
                               int causal, float scale, int dtype, const void* plan, void* stream) {
  const long long sb[15] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos, sgb, sgh, sgs};
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta), B, H, S, Skv, {},
         causal, scale, static_cast<const BwdLaunch*>(plan), static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && !element_strides(sb, a.st)) return int(cudaErrorInvalidValue);
  return dispatch(D, dtype, [&](auto d) { return launch_dq<decltype(d)::value>(a, dq, dtype); });
}

extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int H, int S, int Skv, int D,
                                long long sqb, long long sqh, long long sqs, long long skb, long long skh,
                                long long sks, long long svb, long long svh, long long svs, long long sgb,
                                long long sgh, long long sgs, int causal, float scale, int dtype,
                                const void* plan, void* stream) {
  // The f32 kernel has no o: its strides are a copy of dO's, unread.
  const long long sb[15] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sgb, sgh, sgs, sgb, sgh, sgs};
  Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse), const_cast<float*>(static_cast<const float*>(delta)),
         B, H, S, Skv, {}, causal, scale, static_cast<const BwdLaunch*>(plan), static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && !element_strides(sb, a.st)) return int(cudaErrorInvalidValue);
  return dispatch(D, dtype, [&](auto d) { return launch_dkv<decltype(d)::value>(a, dk, dv, dtype); });
}

// sizeof(BwdLaunch): the wrapper checks its LaunchPlan against it.
extern "C" int rt_flash_bwd_plan_bytes() { return int(sizeof(BwdLaunch)); }
