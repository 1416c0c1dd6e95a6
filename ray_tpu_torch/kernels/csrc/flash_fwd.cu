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
// S ~ 1200 (the serving prompts, the S = 1024 training step) that is under
// the ~295 FLOP/byte bf16 break-even, so the bytes bound it; longer
// sequences are bound by tensor-core operations. So the kernel has to keep
// the copies streaming and the tensor cores fed at once, and keep every
// intermediate on chip: q, k, v are read once per tile, only o (and lse)
// is written.
//
// What held the mma.sync kernel this replaces back, and what this design
// does about each:
//   * no overlap of copies with compute (synchronous 16-byte loads by every
//     thread, two __syncthreads per tile): one producer warp issues TMA
//     copies (Q once per work item, then K and V tiles into a ring of 2-4
//     stages with full / empty mbarriers per stage) and gives its registers
//     up (setmaxnreg); the consumers never spend an instruction on a copy,
//     and copies of the next tiles and the next item's Q run under the
//     current products;
//   * Ampere tensor-core instructions issued one warp at a time:
//     S = Q K^T and O += P V are wgmma m64nNk16 products of whole
//     warpgroups, asynchronous, the consumer warpgroups taking turns at
//     issuing them (named barriers, a ring) so that the tensor cores run the
//     others' products while one computes its softmax; within a warpgroup,
//     softmax(S_j) runs while P_{j-1} V_{j-1} is on the tensor cores;
//   * shared-memory instruction pressure (each warp re-read the K and V
//     tiles for 16 rows; V assembled from 16-bit loads): the tensor cores
//     read Q, K and V straight from shared memory by descriptor, in the
//     128-byte swizzle TMA lands them in (64-byte at D = 32), conflict free;
//     V is the MN-major B operand, read with the transpose bit from the same
//     tile, so it is never transposed; P stays in registers (the S
//     accumulators of a 16-key slice, rounded to bf16 in place as the
//     reference rounds p to v's dtype, are the A fragment);
//   * small 64 x 64 blocks: a work item is 128 q rows (two consumer
//     warpgroups) at D >= 128 and 192 rows (three) at D <= 64, where one
//     warpgroup's softmax (MUFU.EX2-bound) takes as long as two warpgroups'
//     products; key tiles are 128 wide (64 at D = 256, so that Q and two
//     stages fit in shared memory).
// Also: persistent CTAs, one per SM, walk a static list of (b*h, q tile)
// work items, heaviest causal tiles first; the q tiles are aligned to the
// end of the sequence so that a ragged tile is the first, lightest one
// (its rows before 0 are zero-filled by TMA and never stored). The mask is
// evaluated only on diagonal and ragged-tail tiles, and a warpgroup skips
// the products of tiles wholly past its rows. A consumer hands a stage back
// once the products that read it have completed (wgmma.wait_group). The
// epilogue normalises O in registers and, at D <= 128, writes it to a
// swizzled shared-memory tile that one TMA store per column block copies
// out (rows past S are not written); lse is stored directly.
// The products must not be serialised by ptxas (C7513): every register a
// wgmma reads is defined before the wgmma.fence and kept alive until the
// wgmma.wait_group that retires it (reg_fence), descriptors are uniform
// base descriptors plus compile-time offsets. chip_smoke.py fails the build
// if ptxas serialises them or spills.
// TMA descriptors are rank 4 over [B, H, S, D] with the tensors' own
// strides, so a strided view (v of the qkv projection) is read in place
// and a ragged tail zero-fills inside its own head. They are built on the
// host per call and passed as __grid_constant__ parameters, which keeps a
// launch capturable in a CUDA graph.
// The launch plan is Python's (`flash_fwd.launches`, tested on the CPU): the
// stages, shared memory, grid, the q tiles in launch order with the key
// tiles each warpgroup reads (a __grid_constant__ table), and each tensor
// map's dims, byte strides and box. This file computes none of them; it
// refuses a plan whose tile shape is not the one an instantiation was
// compiled for (wgmma shapes and expect-tx byte counts are compile-time).
// Design (f32, the parity runs only): 32x32 tiles with plain FMA (no f32
// tensor-core path is used: the parity runs need full f32 products).

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs;
};

// ------------------------------------------------------------ bf16 path
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use
constexpr int kMaxQTiles = 256;   // q tiles per head a plan may list
constexpr int kTurnThreads = 256;  // a turn's barrier: the warpgroup waiting and the one handing over

template <int D>
struct FwdCfg {
  // Consumer warpgroups of 64 q rows each: three at D <= 64, where one
  // warpgroup's softmax takes as long as two warpgroups' products, two above.
  static constexpr int NWG = D <= 64 ? 3 : 2;
  static constexpr int BQ = 64 * NWG;               // q rows per work item
  static constexpr int THREADS = 128 * (NWG + 1);   // and the producer warpgroup
  static constexpr int CONSUMERS = 128 * NWG;       // arrivals that release a stage or Q
  // The producer gives its registers up to the consumers (setmaxnreg):
  // 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536.
  static constexpr int PRODUCER_REGS = NWG == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = NWG == 3 ? 160 : 232;
  static constexpr int BK = D == 256 ? 64 : 128;    // keys per tile
  static constexpr int SW = D == 32 ? 64 : 128;     // swizzle = bytes of one shared row of a box
  static constexpr int BOX = SW / 2;                // bf16 columns of one TMA box
  static constexpr int KPB = SW / 32;               // k16 slices per column block
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // O is staged in shared memory and stored by TMA where it fits (D <= 128);
  // at D = 256 the threads store it directly.
  static constexpr bool STAGE_O = D <= 128;
  static constexpr int O_BYTES = STAGE_O ? BQ * D * 2 : 0;
  // Q, O, `stages` K and V tiles, 3 barriers per stage and 2 for Q, and the
  // slack that aligns the base to 1024 bytes.
  static constexpr int smem_bytes(int stages) {
    return 1024 + Q_BYTES + O_BYTES + 2 * stages * KV_BYTES + 8 * (3 * stages + 2);
  }
};

// One q tile of a head, as the plan lists them in launch order: its first
// row (negative for a ragged first tile, whose rows before 0 TMA
// zero-fills and nobody stores), the key tiles the producer streams for
// it, and the key tiles each consumer warpgroup reads (a prefix of them; 0
// for a warpgroup without a real row). Work item i is tile i / BH of head
// i % BH. (flash_fwd.QTile / _QTile in Python.)
struct QTile {
  int q0;
  unsigned short n_kv;
  unsigned short n_kv_wg[3];
};
struct QTiles {
  QTile t[kMaxQTiles];
};

// What rt_flash_fwd is handed for a bf16 launch (flash_fwd.LaunchPlan).
struct FwdLaunch {
  int block_q, block_k, swizzle, stages, smem_bytes, grid, n_items, BH;
  TmaSpec maps[4];  // q, k, v, o
  QTiles tiles;
};

// This thread's rows and columns in a consumer warpgroup's accumulators.
struct Rows {
  int first;  // the warpgroup's first q row
  int lo;     // row of acc[4j], acc[4j + 1]; acc[4j + 2], acc[4j + 3] are row lo + 8
  int col;    // column of acc[4j] within its 8-column group
};

// S = Q K^T for one warpgroup: 64 rows x BK keys, D / 16 slices of the head
// dim, both operands K-major in swizzled shared memory. Issues only. The
// descriptors are the tiles' base descriptors plus compile-time offsets
// (the address field is addr >> 4 in the low bits; tiles lie below 256 KB,
// so the sum never carries out of it): no per-thread arithmetic between
// the products, which would make ptxas serialise them.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[FwdCfg<D>::BK / 2], uint64_t q_desc,
                                         uint64_t k_desc) {
  using C = FwdCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = kk / C::KPB, in_block = (kk % C::KPB) * 32;
    Wgmma<C::BK>::ss(s, q_desc + ((col * C::BQ * C::SW + in_block) >> 4),
                     k_desc + ((col * C::BK * C::SW + in_block) >> 4), kk > 0);
  }
}

// O += P V: P (64 x BK, bf16) from registers, V (BK x D) MN-major from
// swizzled shared memory (the transpose bit). Issues only.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&p)[FwdCfg<D>::BK / 16][4],
                                         uint64_t v_desc) {
  using C = FwdCfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    Wgmma<D>::template rs<1>(acc, p[kk], v_desc + ((kk * 16 * C::SW) >> 4), 1);
}

// Online softmax of one S tile in its accumulator registers: mask
// (diagonal and ragged-tail tiles only), update the running max (log2
// units) and sum, leave the probabilities in s, and return in alpha the
// factor the output accumulated so far must be rescaled by. The max is
// taken on the raw scores (scale > 0), so each probability costs one FFMA
// and one EX2.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&s)[FwdCfg<D>::BK / 2], float (&alpha)[2],
                                             float (&m_run)[2], float (&l_run)[2], const Rows& rows,
                                             int k0, int S, int Skv, int causal, float scale_log2) {
  constexpr int BK = FwdCfg<D>::BK;
  const int row_offset = Skv - S;
  if ((k0 + BK > Skv) || (causal && k0 + BK - 1 > row_offset + rows.first)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows.lo + (e >> 1) * 8;
        const int col = k0 + j * 8 + rows.col + (e & 1);
        if (col >= Skv || (causal && row + row_offset < col)) s[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i] * scale_log2);
    // A row with no valid key yet (only rows past S) keeps m = -inf; use 0
    // as its reference so exp2 gives 0, never NaN.
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[i] = exp2_approx(m_run[i] - m_use);
    m_run[i] = m_new;
    neg_m[i] = -m_use;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
  l_run[0] = l_run[0] * alpha[0] + rs[0];
  l_run[1] = l_run[1] * alpha[1] + rs[1];
}

// P rounded to bf16 (as the reference rounds p to v's dtype): the
// accumulators 8i .. 8i + 7 of S are the A fragment of P V's slice i.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[i][e] = pack_bf16(s[8 * i + 2 * e], s[8 * i + 2 * e + 1]);
}

// The consumer warpgroups take turns, in a ring, at issuing their products
// (named barriers 1 .. NWG), so the tensor cores run the others' products
// while one computes its softmax. Warpgroup c waits for its turn on barrier
// 1 + c; ending a turn lets the next one go.
__device__ __forceinline__ void turn_begin(int c) { named_bar_sync(1 + c, kTurnThreads); }
template <int NWG>
__device__ __forceinline__ void turn_end(int c) { named_bar_arrive(1 + (c + 1) % NWG, kTurnThreads); }

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
               uint16_t* __restrict__ o, float* __restrict__ lse, const __grid_constant__ QTiles tiles,
               int H, int S, int Skv, int causal, float scale_log2, int n_items, int BH, int stages) {
  using C = FwdCfg<D>;
  constexpr int BK = C::BK, SW = C::SW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Os = Qs + C::Q_BYTES;  // O staging, 64 rows per consumer warpgroup
  unsigned char* Ks = Os + C::O_BYTES;
  unsigned char* Vs = Ks + stages * C::KV_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + stages * C::KV_BYTES);
  uint64_t* full_v = full_k + stages;
  uint64_t* empty = full_v + stages;
  uint64_t* q_full = empty + stages;
  uint64_t* q_empty = q_full + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, C::CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, C::CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    regs_release<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
      tma_prefetch_desc(&tm_o);
      int stage = 0;
      uint32_t phase = 0;
      int n = 0;  // work items done by this CTA
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const QTile& tile = tiles.t[item / BH];
        const int q0 = tile.q0, bh = item % BH;
        const int b = bh / H, h = bh % H;
        mbar_wait(q_empty, (n & 1) ^ 1);  // the consumers are done with the last Q
        mbar_arrive_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / C::BOX; ++cb)
          tma_load_4d(Qs + cb * C::BQ * SW, &tm_q, q_full, cb * C::BOX, q0, h, b);
        const int n_kt = tile.n_kv;
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);
          unsigned char* kd = Ks + stage * C::KV_BYTES;
          unsigned char* vd = Vs + stage * C::KV_BYTES;
          mbar_arrive_expect_tx(full_k + stage, C::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / C::BOX; ++cb)
            tma_load_4d(kd + cb * BK * SW, &tm_k, full_k + stage, cb * C::BOX, kt * BK, h, b);
          mbar_arrive_expect_tx(full_v + stage, C::KV_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / C::BOX; ++cb)
            tma_load_4d(vd + cb * BK * SW, &tm_v, full_v + stage, cb * C::BOX, kt * BK, h, b);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    regs_claim<C::CONSUMER_REGS>();
    // Consumer warpgroup c takes q rows 64c .. 64c + 63. The shuffle makes
    // c (and so every descriptor) warp-uniform to the compiler.
    const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128 - 1, 0);
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const uint64_t q_desc = wgmma_desc(smem_addr(Qs) + c * 64 * SW, 16, 8 * SW, SW);
    const uint32_t k_smem = smem_addr(Ks), v_smem = smem_addr(Vs);
    // Base descriptors of stage st's K (K-major) and V (MN-major) tiles.
    auto k_desc = [&](int st) { return wgmma_desc(k_smem + st * C::KV_BYTES, 16, 8 * SW, SW); };
    auto v_desc = [&](int st) { return wgmma_desc(v_smem + st * C::KV_BYTES, BK * SW, 8 * SW, SW); };
    int stage = 0;
    uint32_t phase = 0;
    int n = 0;
    if (c == C::NWG - 1) turn_end<C::NWG>(c);  // warpgroup 0 takes the first turn
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const QTile& tile = tiles.t[item / BH];
      const int bh = item % BH;
      Rows rows;
      rows.first = tile.q0 + 64 * c;
      rows.lo = rows.first + warp * 16 + (lane >> 2);  // row of acc[4j], acc[4j+1]; +8 the others
      rows.col = 2 * (lane & 3);
      // The key tiles this warpgroup's real rows see are a prefix of the
      // item's: it waits for and hands back the rest without reading them.
      const int n_kt = tile.n_kv, my_n = tile.n_kv_wg[c];

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
      float l_run[2] = {0.f, 0.f};              // this thread's share of the row sum
      mbar_wait(q_full, n & 1);

      // Every item takes n_kt + 1 turns in each warpgroup: S_0, then
      // (S_j, P_{j-1} V_{j-1}) per tile, then the last P V; a tile past this
      // warpgroup's rows is an empty turn.
      int kt = 0;
      if (my_n > 0) {
        // Software pipeline: while P_{j-1} V_{j-1} runs on the tensor
        // cores, this warpgroup computes softmax(S_j) on its ALUs.
        float s[BK / 2], alpha[2];
        uint32_t p[BK / 16][4];
        mbar_wait(full_k + stage, phase);
        const uint64_t kd = k_desc(stage);
        turn_begin(c);
        wgmma_fence();
        issue_qk<D>(s, q_desc, kd);
        wgmma_commit();
        turn_end<C::NWG>(c);
        wgmma_wait<0>();
        reg_fence(s);
        if (my_n == 1) mbar_arrive(q_empty);  // the last read of this item's Q is done
        softmax_tile<D>(s, alpha, m_run, l_run, rows, 0, S, Skv, causal, scale_log2);
        pack_p<BK>(s, p);
        for (kt = 1; kt < my_n; ++kt) {
          const int prev = stage;
          const uint32_t prev_phase = phase;
          if (++stage == stages) stage = 0, phase ^= 1;
          mbar_wait(full_k + stage, phase);
          mbar_wait(full_v + prev, prev_phase);
          const uint64_t kd = k_desc(stage), vd = v_desc(prev);
          turn_begin(c);
          reg_fence(acc);
          wgmma_fence();
          issue_qk<D>(s, q_desc, kd);
          wgmma_commit();
          issue_pv<D>(acc, p, vd);
          wgmma_commit();
          turn_end<C::NWG>(c);
          wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} may still run
          reg_fence(s);
          if (kt == my_n - 1) mbar_arrive(q_empty);
          softmax_tile<D>(s, alpha, m_run, l_run, rows, kt * BK, S, Skv, causal, scale_log2);
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(p);
          mbar_arrive(empty + prev);  // stage prev's K and V are free again
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[4 * j + 0] *= alpha[0];
            acc[4 * j + 1] *= alpha[0];
            acc[4 * j + 2] *= alpha[1];
            acc[4 * j + 3] *= alpha[1];
          }
          pack_p<BK>(s, p);  // P_{j-1} V_{j-1} no longer reads p
        }
        mbar_wait(full_v + stage, phase);
        const uint64_t vd = v_desc(stage);
        turn_begin(c);
        reg_fence(acc);
        wgmma_fence();
        issue_pv<D>(acc, p, vd);
        wgmma_commit();
        turn_end<C::NWG>(c);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(p);
        mbar_arrive(empty + stage);
        if (++stage == stages) stage = 0, phase ^= 1;
      } else {
        mbar_arrive(q_empty);
        turn_begin(c);  // the turn of S_0
        turn_end<C::NWG>(c);
      }
      for (; kt < n_kt; ++kt) {  // tiles wholly past this warpgroup's rows
        mbar_wait(full_k + stage, phase);
        mbar_wait(full_v + stage, phase);
        turn_begin(c);
        turn_end<C::NWG>(c);
        mbar_arrive(empty + stage);
        if (++stage == stages) stage = 0, phase ^= 1;
      }

      // Full row sums across the quad, then normalise and store.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
        l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
      }
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l_run[i], 1e-30f);
      const int b = bh / H, h = bh % H;
      // A TMA store takes no negative coordinate: a warpgroup whose rows
      // start before row 0 (only in a head's first, ragged q tile) stores
      // directly, as every warpgroup does at D = 256.
      const bool tma_out = C::STAGE_O && rows.first >= 0;
      if (tma_out) {
        // Through shared memory (the TMA box layout, swizzled: conflict-free
        // 4-byte writes) and out by one TMA store per column block; rows
        // past S are not written. The store of the previous item must have
        // read the buffer first.
        unsigned char* ob = Os + c * 64 * D * 2;
        const bool leader = threadIdx.x % 128 == 0;
        if (leader) bulk_wait_read();
        named_bar_sync(1 + C::NWG + c, 128);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = warp * 16 + (lane >> 2) + 8 * i;  // row within the warpgroup's 64
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int cb = j / (C::BOX / 8), chunk = j % (C::BOX / 8);
            const uint32_t off = swizzled(rl * SW + chunk * 16 + rows.col * 2, SW);
            *reinterpret_cast<uint32_t*>(ob + cb * 64 * SW + off) =
                pack_bf16(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
          }
        }
        fence_async_smem();
        named_bar_sync(1 + C::NWG + c, 128);
        if (leader && rows.first < S) {
#pragma unroll
          for (int cb = 0; cb < D / C::BOX; ++cb)
            tma_store_4d(&tm_o, ob + cb * 64 * SW, cb * C::BOX, rows.first, h, b);
          bulk_commit();
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rows.lo + i * 8;
        if (row < 0 || row >= S) continue;
        if (!tma_out) {
          uint16_t* orow = o + ((long long)bh * S + row) * D + rows.col;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + j * 8) =
                pack_bf16(acc[4 * j + 2 * i] * inv[i], acc[4 * j + 2 * i + 1] * inv[i]);
        }
        if (lse != nullptr && rows.col == 0)
          lse[(long long)bh * S + row] =
              (m_run[i] + log2f(fmaxf(l_run[i], 1e-30f))) * 0.69314718055994531f;
      }
    }
    if (C::STAGE_O && threadIdx.x % 128 == 0) bulk_wait_read();  // smem outlives the stores' reads
    if (c == 0) turn_begin(c);  // warpgroup 1's last hand-over: every arrival is matched
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

// ------------------------------------------------------------ host side
// Refuses a plan this instantiation cannot run: another tile shape or
// swizzle than it was compiled for (the copies' expect-tx byte counts and
// the wgmma shapes assume them), tensor maps that are not over these
// shapes, a ring or table out of range, or too little shared memory for
// its layout.
template <int D>
bool plan_fits(const FwdLaunch& p, int B, int H, int S, int Skv) {
  using C = FwdCfg<D>;
  if (p.block_q != C::BQ || p.block_k != C::BK || p.swizzle != C::SW || p.stages < 2 ||
      p.stages > kMaxStages || p.smem_bytes < C::smem_bytes(p.stages) || p.smem_bytes > kMaxSmem ||
      p.grid < 1 || p.BH != B * H || p.n_items < p.BH || p.n_items % p.BH != 0 ||
      p.n_items / p.BH > kMaxQTiles)
    return false;
  const unsigned rows[4] = {C::BQ, C::BK, C::BK, 64};  // o: one consumer warpgroup's rows
  const int lens[4] = {S, Skv, Skv, S};
  for (int i = 0; i < 4; ++i)
    if (!map_fits(p.maps[i], D, lens[i], H, B, C::BOX, rows[i])) return false;
  return true;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int H, int S, int Skv, int causal, float scale, const FwdLaunch& p,
                        cudaStream_t stream) {
  if (!plan_fits<D>(p, B, H, S, Skv)) return cudaErrorInvalidValue;
  cudaError_t err;
  static bool configured = false;
  if ((err = allow_smem(flash_fwd_bf16<D>, kMaxSmem, configured)) != cudaSuccess) return err;
  CUtensorMap tm[4];
  const void* bases[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if ((err = make_map(&tm[i], bases[i], p.maps[i], p.swizzle)) != cudaSuccess) return err;
  flash_fwd_bf16<D><<<p.grid, FwdCfg<D>::THREADS, p.smem_bytes, stream>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<uint16_t*>(o), lse, p.tiles, H, S, Skv, causal,
      scale * kLog2e, p.n_items, p.BH, p.stages);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int H, int S, int Skv, const long long (&sb)[9], int causal, float scale,
                       cudaStream_t stream) {
  for (long long b : sb)
    if (b % 4 != 0) return cudaErrorInvalidValue;
  const Strides st{sb[0] / 4, sb[1] / 4, sb[2] / 4, sb[3] / 4, sb[4] / 4,
                   sb[5] / 4, sb[6] / 4, sb[7] / 4, sb[8] / 4};  // f32 elements
  const size_t smem =
      (size_t(kBQ32) * D + size_t(kBK32) * (D + 1) + size_t(kBK32) * D + kWarps * 8 * 32) * sizeof(float);
  cudaError_t err;
  static bool configured = false;
  if ((err = allow_smem(flash_fwd_f32<D>, smem, configured)) != cudaSuccess) return err;
  const dim3 grid((S + kBQ32 - 1) / kBQ32, B * H);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, S, Skv, st, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                   int S, int Skv, const long long (&sb)[9], int causal, float scale, int dtype,
                   const FwdLaunch* plan, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, B, H, S, Skv, sb, causal, scale, stream);
  if (plan == nullptr) return cudaErrorInvalidValue;
  return launch_bf16<D>(q, k, v, o, lse, B, H, S, Skv, causal, scale, *plan, stream);
}

}  // namespace

// Returns a cudaError_t (0 on success). dtype: 0 = float32, 1 = bfloat16.
// q/k/v are [B, H, S|Skv, D] with unit stride along D and the given
// (batch, head, seq) strides in BYTES; o is contiguous [B, H, S, D]; lse,
// when not NULL, is contiguous [B*H, S] f32. plan is a FwdLaunch
// (`flash_fwd.launch_plan`) for bf16; the f32 path reads the strides and
// ignores it (NULL).
extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int S, int Skv, int D, long long sqb, long long sqh,
                            long long sqs, long long skb, long long skh, long long sks,
                            long long svb, long long svh, long long svs, int causal, float scale,
                            int dtype, const void* plan_ptr, void* stream) {
  const long long sb[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  const FwdLaunch* plan = static_cast<const FwdLaunch*>(plan_ptr);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  switch (D) {
    case 32: return int(launch<32>(q, k, v, o, l, B, H, S, Skv, sb, causal, scale, dtype, plan, s));
    case 64: return int(launch<64>(q, k, v, o, l, B, H, S, Skv, sb, causal, scale, dtype, plan, s));
    case 128: return int(launch<128>(q, k, v, o, l, B, H, S, Skv, sb, causal, scale, dtype, plan, s));
    case 256: return int(launch<256>(q, k, v, o, l, B, H, S, Skv, sb, causal, scale, dtype, plan, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// sizeof(FwdLaunch): the wrapper checks its LaunchPlan against it.
extern "C" int rt_flash_fwd_plan_bytes() { return int(sizeof(FwdLaunch)); }
