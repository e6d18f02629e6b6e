// TATP per-round GEMM for Hopper (sm_90a): C[M, K] = A[M, N] @ B[N, K].
//
// Replaces the Pallas TPU kernel src/repro/kernels/tatp_matmul/kernel.py
// (_matmul_kernel, launched by matmul): the MXU-tiled GEMM that computes
// one TATP ring round's tile with an fp32 accumulator in VMEM scratch and
// writes each output block once, cast to the output dtype.
//
// What bounds it on this card: at the main paths' prefill shapes (M 512
// for deepseek-7b, 2048 for the SSM models; N x K from 1536 x 6448 to
// 11008 x 4096) a GEMM does 300-800 bf16 operations per byte it must
// move, above the H100's ~295 operations/byte balance point, so it is
// bound by tensor-core throughput.  Only wgmma reaches that rate (mma.sync
// and the wmma fragments built on it cannot), and wgmma wants both
// operands in shared memory in the layout TMA writes, so the kernel is
// built around TMA and wgmma.
//
// Operand layouts.  Each operand is read in place, rows contiguous
// (layout 0: A[m, n] at a[m * lda + n], B[n, k] at b[n * ldb + k]) or
// transposed (layout 1: A[m, n] at a[n * lda + m], B[n, k] at b[k * ldb +
// n]), so the backward's products dgrad dy @ w^T (B transposed) and wgrad
// x^T @ dy (A transposed) read the saved tensors as they lie.  In wgmma
// terms the forward has a K-major A and an MN-major B; dgrad a K-major B
// (the transpose bit cleared); wgrad an MN-major A (the transpose bit set,
// which wgmma allows for bf16 operands in shared memory).  The TMA boxes
// follow the layout: a K-major operand is loaded as boxes of rows of 64
// contraction elements (one 128-byte swizzled line each), an MN-major one
// as 64 x 64 boxes with the output index contiguous.
//
// Three paths, chosen by the wrapper (kernels/tatp_matmul/ops.py:_path)
// and refused here (cudaErrorInvalidValue) if their preconditions fail:
//   * wgmma (bf16 operands that TMA can describe: 16-byte aligned bases,
//     row pitches a multiple of 16 bytes): a persistent grid of clusters
//     of two blocks, one block per SM, walks pairs of vertically adjacent
//     128 x BN output tiles (BN 128 or 256, picked by the wrapper).  In
//     each block one producer warpgroup (registers lowered with
//     setmaxnreg) has one thread issue TMA loads (128-byte swizzle) of
//     64-wide contraction slices of A (K-major in wgmma terms) and B (the
//     weights as stored, [N, K] row-major: MN-major, read with wgmma's
//     transpose bit, so the weights are never copied) into a ring of 4-6
//     stages guarded by full/empty mbarrier pairs.  The two blocks of a
//     cluster need the same B slice: each loads half of its boxes and
//     multicasts them to both, which halves B's traffic out of L2, the
//     limit of a 128 x BN tile's loads on this card.  Two consumer
//     warpgroups (registers raised) each run wgmma.m64nBNk16 on 64 rows,
//     keeping one stage's products in flight while the previous stage is
//     released to both blocks' producers, and accumulate in fp32
//     registers.  TMA zero-fills boxes past the matrices, so ragged M, N
//     and K need no special case; the epilogue masks stores past M and K
//     and converts to the output type as it writes.  The producer runs
//     ahead into the next tile while the consumers store this one.
//   * wmma (other bf16): one 256-thread block per 128 x 128 tile,
//     nvcuda::wmma fragments (col_major for a transposed operand) fed by a
//     two-stage cp.async pipeline (masked scalar loads where rows are not
//     16-byte aligned).
//   * simt (fp32): one 256-thread block per 64 x 64 tile, fp32 FMAs, so
//     fp32 results are true fp32 products (no TF32); it takes both strides
//     of each operand.

#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

// dtype codes shared with kernels/tatp_matmul/ops.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// path codes shared with kernels/tatp_matmul/ops.py (_PATHS)
constexpr int kPathSimt = 0;
constexpr int kPathWmma = 1;
constexpr int kPathWgmma = 2;

// ---------------------------------------------------------------------------
// bf16 legacy tensor-core path (wmma): operands TMA cannot describe
// ---------------------------------------------------------------------------

constexpr int TM = 128;  // output rows per block (M)
constexpr int TK = 128;  // output cols per block (K)
constexpr int TN = 32;   // contraction slice (N)
constexpr int THREADS = 256;
// padded smem pitches (elements): A as [TM][TN] (rows) or [TN][TM]
// (transposed), B as [TN][TK] (rows) or [TK][TN] (transposed)
constexpr int A_LD = TN + 8;
constexpr int AT_LD = TM + 8;
constexpr int B_LD = TK + 8;
constexpr int BT_LD = TN + 8;
constexpr int A_BUF = TM * A_LD > TN * AT_LD ? TM * A_LD : TN * AT_LD;
constexpr int B_BUF = TN * B_LD > TK * BT_LD ? TN * B_LD : TK * BT_LD;

union __align__(128) Smem {
  struct {
    bf16 a[2][A_BUF];
    bf16 b[2][B_BUF];
  } pipe;
  float c[THREADS / 32][16 * 16];  // the epilogue's staging, after the loop
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 8 contiguous elements of one operand row at src (row r0 + r of the
// stored matrix, columns c0 + 8 cv ..) into dst, zero past rows / cols.
template <bool VEC>
__device__ __forceinline__ void load8(bf16* dst, const bf16* base,
                                      int64_t row, int64_t col, int64_t rows,
                                      int64_t cols, int64_t ld) {
  if (VEC) {
    const bool ok = row < rows && col < cols;
    cp_async16(dst, ok ? base + row * ld + col : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (row < rows && col + e < cols) ? base[row * ld + col + e]
                                              : __float2bfloat16(0.f);
  }
}

// Stage the A[m0:m0+TM, n0:n0+TN] and B[n0:n0+TN, k0:k0+TK] slices into
// buffer `buf` in their stored layouts, zero outside the matrices.  Each
// thread moves two 8-element vectors of A and two of B.
template <bool VEC, bool TA, bool TB>
__device__ __forceinline__ void load_slices(Smem& sm, int buf, const bf16* A,
                                            const bf16* B, int64_t M,
                                            int64_t N, int64_t K,
                                            int64_t lda, int64_t ldb,
                                            int64_t m0, int64_t n0,
                                            int64_t k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = tid + i * THREADS;
    if (TA) {  // TN stored rows (n) x (TM / 8) vectors along m
      const int r = v / (TM / 8), cv = v % (TM / 8);
      load8<VEC>(&sm.pipe.a[buf][r * AT_LD + cv * 8], A, n0 + r,
                 m0 + cv * 8, N, M, lda);
    } else {  // TM rows (m) x (TN / 8) vectors along n
      const int r = v / (TN / 8), cv = v % (TN / 8);
      load8<VEC>(&sm.pipe.a[buf][r * A_LD + cv * 8], A, m0 + r,
                 n0 + cv * 8, M, N, lda);
    }
    if (TB) {  // TK stored rows (k) x (TN / 8) vectors along n
      const int r = v / (TN / 8), cv = v % (TN / 8);
      load8<VEC>(&sm.pipe.b[buf][r * BT_LD + cv * 8], B, k0 + r,
                 n0 + cv * 8, K, N, ldb);
    } else {  // TN rows (n) x (TK / 8) vectors along k
      const int r = v / (TK / 8), cv = v % (TK / 8);
      load8<VEC>(&sm.pipe.b[buf][r * B_LD + cv * 8], B, n0 + r,
                 k0 + cv * 8, N, K, ldb);
    }
  }
}

template <bool VEC, bool TA, bool TB, typename OutT>
__global__ void __launch_bounds__(THREADS)
    gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
              OutT* __restrict__ C, int64_t M, int64_t N, int64_t K,
              int64_t lda, int64_t ldb, int64_t ldc) {
  using LA = typename std::conditional<TA, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<TB, wmma::col_major,
                                       wmma::row_major>::type;
  __shared__ Smem sm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4;  // warp sub-tile: 64 rows x 32 cols
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * TM;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * TK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int64_t n_slices = (N + TN - 1) / TN;
  load_slices<VEC, TA, TB>(sm, 0, A, B, M, N, K, lda, ldb, m0, 0, k0);
  cp_async_commit();
  for (int64_t t = 0; t < n_slices; ++t) {
    if (t + 1 < n_slices) {
      load_slices<VEC, TA, TB>(sm, (t + 1) & 1, A, B, M, N, K, lda, ldb, m0,
                               (t + 1) * TN, k0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = sm.pipe.a[t & 1];
    const bf16* bs = sm.pipe.b[t & 1];
#pragma unroll
    for (int kk = 0; kk < TN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr * 64 + i * 16;
        if (TA)
          wmma::load_matrix_sync(fa[i], as + kk * AT_LD + r, AT_LD);
        else
          wmma::load_matrix_sync(fa[i], as + r * A_LD + kk, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wc * 32 + j * 16;
        if (TB)
          wmma::load_matrix_sync(fb[j], bs + c * BT_LD + kk, BT_LD);
        else
          wmma::load_matrix_sync(fb[j], bs + kk * B_LD + c, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration refills this buffer
  }

  float* stage = sm.c[warp];  // the pipeline buffers are free now
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int64_t gm = m0 + wr * 64 + i * 16 + e / 16;
        const int64_t gk = k0 + wc * 32 + j * 16 + e % 16;
        if (gm < M && gk < K) store_out(&C[gm * ldc + gk], stage[e]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 wgmma path: TMA ring, one producer warpgroup, two consumer
// warpgroups
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;  // output rows per block: 64 per consumer
constexpr int WG_BK = 64;   // contraction slice: one 128-byte swizzle row
constexpr int WG_THREADS = 384;
constexpr int A_STAGE = WG_BM * WG_BK * 2;  // 16 KB
constexpr int B_CHUNK = WG_BK * 64 * 2;     // one 64 x 64 box, 8 KB

template <int BN>
struct WgCfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int STAGE = A_STAGE + (BN / 64) * B_CHUNK;
  // stages, the full/empty barriers, and slack to align the ring to the
  // 1024-byte swizzle atom
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float x, float y,
                                           bool two, bool vec) {
  if (two && vec) {
    if constexpr (sizeof(OutT) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(x, y);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    store_out(p, x);
    if (two) store_out(p + 1, y);
  }
}

// Persistent, in clusters of two blocks on neighbouring SMs: cluster c
// computes tile pairs c, c + clusters, ..., each pair two vertically
// adjacent WG_BM x BN output tiles (M-pair index fastest, so the clusters
// in flight share B's columns), one per block.  For each tile, stage s of
// the ring holds A[m0:+128, n:+64] and B[n:+64, k0:+BN], zero past the
// matrices: A in rows as one 128 x 64 box (K-major for wgmma: each row one
// 128-byte swizzled line), or transposed (TA) as two 64 x 64 boxes with m
// contiguous (MN-major); B in rows as BN / 64 boxes of 64 x 64 (MN-major:
// output columns contiguous), or transposed (TB) as BN / 64 boxes of 64
// output columns x 64 contraction elements (K-major).  Both blocks of a pair need the same B: each loads half of its
// boxes and multicasts them to both, so B crosses L2 once per pair.  A
// block's producer may refill stage s only when the consumers of both
// blocks have released it, so each consumer warp arrives on the empty
// barrier of both blocks.  The producer runs ahead across tiles, so the
// next tile's loads overlap this tile's epilogue.
template <int BN, bool TA, bool TB, typename OutT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(WG_THREADS, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, OutT* __restrict__ C,
               int M, int K, int n_iters, int64_t ldc) {
  using Cfg = WgCfg<BN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Cfg::STAGE);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);    // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 16);  // each consumer warp of both blocks
    }
    mbar_fence_init();
  }
  cluster_sync();  // both blocks' barriers exist before any remote use
  const uint32_t rank = cluster_ctarank();
  const int m_pairs = ((M + WG_BM - 1) / WG_BM + 1) / 2;
  const int pairs = m_pairs * ((K + BN - 1) / BN);
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;

  if (wg == 0) {  // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int it = 0;  // ring position, carried across tiles
      for (int pt = cluster; pt < pairs; pt += clusters) {
        const int m0 = ((pt % m_pairs) * 2 + rank) * WG_BM;
        const int k0 = (pt / m_pairs) * BN;
        for (int kb = 0; kb < n_iters; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * Cfg::STAGE;
          mbar_arrive_expect_tx(&full[s], Cfg::STAGE);
          if (TA) {
            tma_load_2d(st, &ta, &full[s], m0, kb * WG_BK);
            tma_load_2d(st + B_CHUNK, &ta, &full[s], m0 + 64, kb * WG_BK);
          } else {
            tma_load_2d(st, &ta, &full[s], kb * WG_BK, m0);
          }
#pragma unroll
          for (int j = rank; j < BN / 64; j += 2) {
            if (TB)
              tma_load_2d_multicast(st + A_STAGE + j * B_CHUNK, &tb,
                                    &full[s], kb * WG_BK, k0 + j * 64, 0x3);
            else
              tma_load_2d_multicast(st + A_STAGE + j * B_CHUNK, &tb,
                                    &full[s], k0 + j * 64, kb * WG_BK, 0x3);
          }
        }
      }
      // stay until both blocks' consumers have released every stage: no
      // remote arrive or multicast may reach this block after it exits
      for (int j = it - STAGES > 0 ? it - STAGES : 0; j < it; ++j)
        mbar_wait(&empty[j % STAGES], (j / STAGES) & 1);
    }
  } else {  // consumers: 64 rows x BN columns each, fp32 in registers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const bool vec = (ldc % 2) == 0;
    float acc[BN / 2];
    int it = 0;
    for (int pt = cluster; pt < pairs; pt += clusters) {
      const int m0 = ((pt % m_pairs) * 2 + rank) * WG_BM;
      const int k0 = (pt / m_pairs) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < n_iters; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint8_t* st = ring + s * Cfg::STAGE;
        wgmma_fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          // K-major: 16 contraction columns (32 bytes) in, 8-row groups
          // 1 KB apart.  MN-major: 16 contraction rows (2 KB) down, 64-wide
          // chunks 8 KB apart.  A: this consumer's 64 rows (its chunk).
          const uint64_t da =
              TA ? wgmma_desc(st + cw * B_CHUNK + kk * 16 * 128, B_CHUNK,
                              1024)
                 : wgmma_desc(st + cw * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db =
              TB ? wgmma_desc(st + A_STAGE + kk * 32, 16, 1024)
                 : wgmma_desc(st + A_STAGE + kk * 16 * 128, B_CHUNK, 1024);
          if constexpr (BN == 256)
            wgmma_m64n256k16<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
          else
            wgmma_m64n128k16<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
        }
        wgmma_commit();
        // keep this stage's products in flight; the previous stage's are
        // done, so its buffers go back to both blocks' producers
        wgmma_wait<1>();
        wgmma_fence_regs(acc);
        if (kb > 0 && lane == 0) {
          mbar_arrive_cluster(&empty[(it + STAGES - 1) % STAGES], 0);
          mbar_arrive_cluster(&empty[(it + STAGES - 1) % STAGES], 1);
        }
      }
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      if (n_iters > 0 && lane == 0) {
        mbar_arrive_cluster(&empty[(it + STAGES - 1) % STAGES], 0);
        mbar_arrive_cluster(&empty[(it + STAGES - 1) % STAGES], 1);
      }

      // accumulator layout: per 8-column block j, rows g and g + 8 of this
      // warp's 16, columns 2 (lane % 4) + {0, 1}
      const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = k0 + j * 8 + 2 * (lane % 4);
        if (col < K) {
          const bool two = col + 1 < K;
          if (r0 < M)
            store_pair(&C[r0 * ldc + col], acc[4 * j], acc[4 * j + 1], two,
                       vec);
          if (r0 + 8 < M)
            store_pair(&C[(r0 + 8) * ldc + col], acc[4 * j + 2],
                       acc[4 * j + 3], two, vec);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 SIMT path
// ---------------------------------------------------------------------------

constexpr int FM = 64, FK = 64, FN = 16;

// A[m, n] at A[m * sam + n * san], B[n, k] at B[n * sbn + k * sbk]; a_t /
// b_t (the operand's unit stride is on m / on n) pick the staging order
// that keeps a warp's loads on neighbouring addresses.
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
             OutT* __restrict__ C, int64_t M, int64_t N, int64_t K,
             int64_t sam, int64_t san, int64_t sbn, int64_t sbk,
             int64_t ldc, int a_t, int b_t) {
  __shared__ float as[FN][FM + 4];  // A slice, transposed: as[n][m]
  __shared__ float bs[FN][FK + 4];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;  // 4 x 4 outputs per thread
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * FM;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * FK;
  float acc[4][4] = {};
  for (int64_t n0 = 0; n0 < N; n0 += FN) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS;
      {
        const int r = a_t ? e % FM : e / FN, c = a_t ? e / FM : e % FN;
        const int64_t gm = m0 + r, gn = n0 + c;
        as[c][r] = (gm < M && gn < N) ? A[gm * sam + gn * san] : 0.f;
      }
      {
        const int r = b_t ? e % FN : e / FK, c = b_t ? e / FN : e % FK;
        const int64_t gn = n0 + r, gk = k0 + c;
        bs[r][c] = (gn < N && gk < K) ? B[gn * sbn + gk * sbk] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < FN; ++n) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[n][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[n][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + tr * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gk = k0 + tc * 4 + j;
      if (gm < M && gk < K) store_out(&C[gm * ldc + gk], acc[i][j]);
    }
  }
}

template <bool TA, bool TB, typename OutT>
void launch_bf16(const void* a, const void* b, void* c, int64_t M, int64_t N,
                 int64_t K, int64_t lda, int64_t ldb, int64_t ldc,
                 cudaStream_t s) {
  // 16-byte vectors run along each operand's contiguous dim
  const bool vec = lda % 8 == 0 && ldb % 8 == 0 && (TA ? M : N) % 8 == 0 &&
                   (TB ? N : K) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid(static_cast<unsigned>((K + TK - 1) / TK),
            static_cast<unsigned>((M + TM - 1) / TM));
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  OutT* C = static_cast<OutT*>(c);
  if (vec)
    gemm_bf16<true, TA, TB, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K,
                                                           lda, ldb, ldc);
  else
    gemm_bf16<false, TA, TB, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, N,
                                                            K, lda, ldb, ldc);
}

template <typename OutT>
void launch_bf16_l(const void* a, const void* b, void* c, int64_t M,
                   int64_t N, int64_t K, int64_t lda, int64_t ldb,
                   int64_t ldc, int la, int lb, cudaStream_t s) {
  if (la == 0 && lb == 0)
    launch_bf16<false, false, OutT>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else if (la == 0)
    launch_bf16<false, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else if (lb == 0)
    launch_bf16<true, false, OutT>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else
    launch_bf16<true, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc, s);
}

template <typename OutT>
void launch_f32(const void* a, const void* b, void* c, int64_t M, int64_t N,
                int64_t K, int64_t lda, int64_t ldb, int64_t ldc, int la,
                int lb, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((K + FK - 1) / FK),
            static_cast<unsigned>((M + FM - 1) / FM));
  gemm_f32<OutT><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<OutT*>(c), M, N, K, la ? 1 : lda, la ? lda : 1,
      lb ? 1 : ldb, lb ? ldb : 1, ldc, la, lb);
}

// What TMA can describe: 16-byte aligned bases, pitches a multiple of 16
// bytes, a non-empty contraction, 32-bit coordinates.
bool tma_ok(const void* a, const void* b, int64_t M, int64_t N, int64_t K,
            int64_t lda, int64_t ldb) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 && lda % 8 == 0 &&
         ldb % 8 == 0 && N >= 1 && M < (int64_t(1) << 31) &&
         N < (int64_t(1) << 31) && K < (int64_t(1) << 31);
}

template <int BN, bool TA, bool TB, typename OutT>
int launch_wgmma(const void* a, const void* b, void* c, int64_t M, int64_t N,
                 int64_t K, int64_t lda, int64_t ldb, int64_t ldc,
                 cudaStream_t s) {
  CUtensorMap ta, tb;
  const bool maps =
      (TA ? make_tma_2d_bf16(&ta, a, N, M, lda, WG_BK, 64)
          : make_tma_2d_bf16(&ta, a, M, N, lda, WG_BM, WG_BK)) &&
      (TB ? make_tma_2d_bf16(&tb, b, K, N, ldb, 64, WG_BK)
          : make_tma_2d_bf16(&tb, b, N, K, ldb, WG_BK, 64));
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gemm_wgmma<BN, TA, TB, OutT>;
  const int smem = WgCfg<BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one cluster of two blocks per pair of tiles, at most one block per SM
  const int64_t pairs =
      ((M + WG_BM - 1) / WG_BM + 1) / 2 * ((K + BN - 1) / BN);
  const unsigned grid =
      2 * static_cast<unsigned>(pairs < sms / 2 ? pairs : sms / 2);
  kern<<<grid, WG_THREADS, smem, s>>>(
      ta, tb, static_cast<OutT*>(c), static_cast<int>(M),
      static_cast<int>(K), static_cast<int>((N + WG_BK - 1) / WG_BK), ldc);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, typename OutT>
int launch_wgmma_l(const void* a, const void* b, void* c, int64_t M,
                   int64_t N, int64_t K, int64_t lda, int64_t ldb,
                   int64_t ldc, int la, int lb, cudaStream_t s) {
  if (la == 0 && lb == 0)
    return launch_wgmma<BN, false, false, OutT>(a, b, c, M, N, K, lda, ldb,
                                                ldc, s);
  if (la == 0)
    return launch_wgmma<BN, false, true, OutT>(a, b, c, M, N, K, lda, ldb,
                                               ldc, s);
  if (lb == 0)
    return launch_wgmma<BN, true, false, OutT>(a, b, c, M, N, K, lda, ldb,
                                               ldc, s);
  return launch_wgmma<BN, true, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc,
                                            s);
}

template <typename OutT>
int launch_wgmma_n(const void* a, const void* b, void* c, int64_t M,
                   int64_t N, int64_t K, int64_t lda, int64_t ldb,
                   int64_t ldc, int la, int lb, int tile_n, cudaStream_t s) {
  if (tile_n == 256)
    return launch_wgmma_l<256, OutT>(a, b, c, M, N, K, lda, ldb, ldc, la, lb,
                                     s);
  if (tile_n == 128)
    return launch_wgmma_l<128, OutT>(a, b, c, M, N, K, lda, ldb, ldc, la, lb,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// C[M, K] = A[M, N] @ B[N, K].  la / lb: each operand's layout, 0 (rows
// contiguous; lda / ldb the stride between rows) or 1 (transposed: the
// stored matrix is A^T [N, M] or B^T [K, N]; lda / ldb the stride between
// its rows).  C is row-major with row stride ldc.  path: kPathSimt (fp32
// operands), kPathWmma (bf16) or kPathWgmma (bf16 that TMA can describe;
// tile_n 128 or 256 output columns per block).  A path whose
// preconditions fail returns cudaErrorInvalidValue without launching;
// otherwise the result is cudaGetLastError() after the launch (0 =
// launched).
int tatp_matmul_launch(const void* a, const void* b, void* c, int64_t M,
                       int64_t N, int64_t K, int64_t lda, int64_t ldb,
                       int64_t ldc, int la, int lb, int in_dtype,
                       int out_dtype, int path, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  // the row-tile index is blockIdx.y (at most 65535 tiles of >= 64 rows)
  if (M <= 0 || K <= 0 || N < 0 || (M + FM - 1) / FM > 65535 ||
      (out_dtype != kF32 && out_dtype != kBF16) || (la != 0 && la != 1) ||
      (lb != 0 && lb != 1))
    return bad;
  const bool out_f32 = out_dtype == kF32;
  if (path == kPathSimt && in_dtype == kF32) {
    if (out_f32)
      launch_f32<float>(a, b, c, M, N, K, lda, ldb, ldc, la, lb, s);
    else
      launch_f32<bf16>(a, b, c, M, N, K, lda, ldb, ldc, la, lb, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == kPathWmma && in_dtype == kBF16) {
    if (out_f32)
      launch_bf16_l<float>(a, b, c, M, N, K, lda, ldb, ldc, la, lb, s);
    else
      launch_bf16_l<bf16>(a, b, c, M, N, K, lda, ldb, ldc, la, lb, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == kPathWgmma && in_dtype == kBF16 &&
      tma_ok(a, b, M, N, K, lda, ldb)) {
    return out_f32 ? launch_wgmma_n<float>(a, b, c, M, N, K, lda, ldb, ldc,
                                           la, lb, tile_n, s)
                   : launch_wgmma_n<bf16>(a, b, c, M, N, K, lda, ldb, ldc,
                                          la, lb, tile_n, s);
  }
  return bad;
}

}  // extern "C"
