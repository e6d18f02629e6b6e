// TATP per-round GEMM for Hopper (sm_90a): C[M, K] = A[M, N] @ B[N, K].
//
// Replaces the Pallas TPU kernel src/repro/kernels/tatp_matmul/kernel.py
// (_matmul_kernel, launched by matmul): the MXU-tiled GEMM that computes
// one TATP ring round's tile with an fp32 accumulator in VMEM scratch and
// writes each output block once, cast to the output dtype.
//
// What bounds it on this card: at the main path's prefill shapes
// (M = batch * prompt_len = 512, N x K in {4096x4096, 4096x11008,
// 11008x4096}) a GEMM does ~1000 bf16 operations per byte of weight it
// reads, far above the H100's ~295 operations/byte balance point, so it is
// bound by tensor-core throughput.
//
// Design (first, simple version; wgmma + TMA + warp specialisation come
// later):
//   * bf16: one 256-thread block per 128 x 128 output tile.  The TPU
//     grid's sequential contraction axis becomes a loop over 32-wide
//     slices of N inside the block.  A and B slices are staged through
//     shared memory in two buffers: cp.async (16-byte, zero-filling past
//     the ragged edge) loads slice t+1 while the tensor cores (nvcuda::wmma
//     bf16 16x16x16 fragments, fp32 accumulate) consume slice t.  Each of
//     the 8 warps owns a 64 x 32 sub-tile held in fp32 registers.  The
//     epilogue goes through a 1 KB per-warp staging tile, masks the ragged
//     M/K edge and casts to the output dtype.  Operands whose rows are not
//     16-byte aligned take the same kernel with plain masked loads.
//   * fp32: a SIMT kernel (one 256-thread block per 64 x 64 tile, 4 x 4
//     outputs per thread, 16-wide contraction slices in shared memory,
//     fp32 FMA) so fp32 results are true fp32 products (no TF32).
//   * Ragged M, N and K are masked in-kernel: no shape needs a tile
//     multiple (11008 = 43 x 256 is not a multiple of 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

// dtype codes shared with kernels/tatp_matmul/ops.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------

constexpr int TM = 128;  // output rows per block (M)
constexpr int TK = 128;  // output cols per block (K)
constexpr int TN = 32;   // contraction slice (N)
constexpr int THREADS = 256;
constexpr int A_LD = TN + 8;  // padded smem row pitch (elements)
constexpr int B_LD = TK + 8;

struct __align__(128) Smem {
  bf16 a[2][TM * A_LD];
  bf16 b[2][TN * B_LD];
  float c[THREADS / 32][16 * 16];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes zero
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage the A[m0:m0+TM, n0:n0+TN] and B[n0:n0+TN, k0:k0+TK] slices into
// buffer `buf`, zero outside the matrices.  Each thread moves two 8-element
// vectors of A and two of B.
template <bool VEC>
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
    {  // A: TM rows x (TN / 8) vectors
      const int r = v / (TN / 8), cv = v % (TN / 8);
      const int64_t gm = m0 + r, gn = n0 + cv * 8;
      bf16* dst = &sm.a[buf][r * A_LD + cv * 8];
      if (VEC) {
        const bool ok = gm < M && gn < N;
        cp_async16(dst, ok ? A + gm * lda + gn : A, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gn + e < N) ? A[gm * lda + gn + e]
                                          : __float2bfloat16(0.f);
      }
    }
    {  // B: TN rows x (TK / 8) vectors
      const int r = v / (TK / 8), cv = v % (TK / 8);
      const int64_t gn = n0 + r, gk = k0 + cv * 8;
      bf16* dst = &sm.b[buf][r * B_LD + cv * 8];
      if (VEC) {
        const bool ok = gn < N && gk < K;
        cp_async16(dst, ok ? B + gn * ldb + gk : B, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gn < N && gk + e < K) ? B[gn * ldb + gk + e]
                                          : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
    gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
              OutT* __restrict__ C, int64_t M, int64_t N, int64_t K,
              int64_t lda, int64_t ldb, int64_t ldc) {
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
  load_slices<VEC>(sm, 0, A, B, M, N, K, lda, ldb, m0, 0, k0);
  cp_async_commit();
  for (int64_t t = 0; t < n_slices; ++t) {
    if (t + 1 < n_slices) {
      load_slices<VEC>(sm, (t + 1) & 1, A, B, M, N, K, lda, ldb, m0,
                       (t + 1) * TN, k0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = sm.a[t & 1];
    const bf16* bs = sm.b[t & 1];
#pragma unroll
    for (int kk = 0; kk < TN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], as + (wr * 64 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wc * 32 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration refills this buffer
  }

  float* stage = sm.c[warp];
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
// fp32 SIMT path
// ---------------------------------------------------------------------------

constexpr int FM = 64, FK = 64, FN = 16;

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
             OutT* __restrict__ C, int64_t M, int64_t N, int64_t K,
             int64_t lda, int64_t ldb, int64_t ldc) {
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
        const int r = e / FN, c = e % FN;
        const int64_t gm = m0 + r, gn = n0 + c;
        as[c][r] = (gm < M && gn < N) ? A[gm * lda + gn] : 0.f;
      }
      {
        const int r = e / FK, c = e % FK;
        const int64_t gn = n0 + r, gk = k0 + c;
        bs[r][c] = (gn < N && gk < K) ? B[gn * ldb + gk] : 0.f;
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

template <typename OutT>
void launch_bf16(const void* a, const void* b, void* c, int64_t M, int64_t N,
                 int64_t K, int64_t lda, int64_t ldb, int64_t ldc,
                 cudaStream_t s) {
  const bool vec = lda % 8 == 0 && ldb % 8 == 0 && N % 8 == 0 &&
                   K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  dim3 grid(static_cast<unsigned>((K + TK - 1) / TK),
            static_cast<unsigned>((M + TM - 1) / TM));
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  OutT* C = static_cast<OutT*>(c);
  if (vec)
    gemm_bf16<true, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K, lda,
                                                   ldb, ldc);
  else
    gemm_bf16<false, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, N, K, lda,
                                                    ldb, ldc);
}

template <typename OutT>
void launch_f32(const void* a, const void* b, void* c, int64_t M, int64_t N,
                int64_t K, int64_t lda, int64_t ldb, int64_t ldc,
                cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((K + FK - 1) / FK),
            static_cast<unsigned>((M + FM - 1) / FM));
  gemm_f32<OutT><<<grid, THREADS, 0, s>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(b),
                                          static_cast<OutT*>(c), M, N, K,
                                          lda, ldb, ldc);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() after the launch (0 = launched).
int tatp_matmul_launch(const void* a, const void* b, void* c, int64_t M,
                       int64_t N, int64_t K, int64_t lda, int64_t ldb,
                       int64_t ldc, int in_dtype, int out_dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the row-tile index is blockIdx.y (at most 65535 tiles of >= 64 rows)
  if (M <= 0 || K <= 0 || N < 0 || (M + FM - 1) / FM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    launch_bf16<bf16>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else if (in_dtype == kBF16 && out_dtype == kF32)
    launch_bf16<float>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else if (in_dtype == kF32 && out_dtype == kF32)
    launch_f32<float>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else if (in_dtype == kF32 && out_dtype == kBF16)
    launch_f32<bf16>(a, b, c, M, N, K, lda, ldb, ldc, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
