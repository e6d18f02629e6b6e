// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention): online-softmax attention
// with GQA head groups, a top-left-aligned causal mask (query and key
// positions both start at 0), a sliding window (qpos - kpos < window), tanh
// soft-capping of the scaled logits, NEG_INF = -1e30 masking with masked
// probabilities zeroed and the row sum clamped at 1e-20 (a fully masked row
// gives 0), and key blocks above the causal diagonal skipped.
//
// What bounds it on this card: at the main path's prefill shape
// (q/k/v [4, 32, 128, 128] bf16, causal) a launch moves 16 MB and does
// ~0.5 GFLOP, ~33 operations per byte, below the H100's ~295 operations/
// byte balance point, so its floor is memory traffic (~5 us).  This first
// version runs the products on the CUDA cores (fp32 FMA from shared
// memory), so in practice it is bound by shared-memory bandwidth and FMA
// issue, not by HBM; tensor cores (wgmma) come in a later version.
//
// Design:
//   * One 128-thread block per (batch * q-head, 32-row query tile).  The
//     TPU grid's sequential key-block axis becomes a loop over 32-key tiles
//     inside the block; the online-softmax state (m, l, acc) stays in fp32
//     registers for the whole loop and the output tile is written once.
//   * Four threads own one query row: each computes 8 of the tile's 32
//     logits, the row max and sum combine with two warp shuffles, and each
//     thread keeps a quarter of the row's fp32 accumulator (D/4 values).
//   * Q, K and V tiles are converted to fp32 in shared memory with a
//     padded row pitch (D + 1) so the dot-product reads are conflict-free.
//     At D = 256 the block needs ~100 KB of dynamic shared memory, above
//     the 48 KB default, so the launcher raises the limit.
//   * Key tiles entirely above the causal diagonal or entirely outside the
//     window are skipped; ragged Sq/Skv edges are masked in-kernel.
//   * Any batch/head/sequence strides (unit stride on D), so [B, S, H, D]
//     activations are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// dtype codes shared with kernels/flash_attention/ops.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr int BQ = 32;    // query rows per block
constexpr int BKV = 32;   // keys per tile
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
         (static_cast<size_t>(BQ) * ld + 2 * static_cast<size_t>(BKV) * ld +
          static_cast<size_t>(BQ) * (BKV + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
              int Sq, int Skv, int D, int64_t qsb, int64_t qsh, int64_t qss,
              int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
              int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
              int64_t oss, float scale, int causal, int window, float cap) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;            // [BQ][ld]
  float* ks = qs + BQ * ld;    // [BKV][ld]
  float* vs = ks + BKV * ld;   // [BKV][ld]
  float* ps = vs + BKV * ld;   // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // query row within the tile
  const int sub = tid & 3;   // this thread's quarter of the row
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);  // GQA: kv head of this q head
  const int q0 = blockIdx.y * BQ;
  const int qpos = q0 + row;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * ld + c] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * qss + c]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DMAX / 4];
#pragma unroll
  for (int e = 0; e < DMAX / 4; ++e) acc[e] = 0.f;

  // key tiles that can hold an unmasked key for some row of this tile
  int k_end = Skv;
  if (causal) k_end = min(Skv, min(q0 + BQ, Sq));
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / BKV * BKV;

  for (int j0 = k_begin; j0 < k_end; j0 += BKV) {
    __syncthreads();  // Q staged / previous tile's K, V, P reads done
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = j0 + r < Skv;
      ks[r * ld + c] = in ? to_f(kb[(j0 + r) * kss + c]) : 0.f;
      vs[r * ld + c] = in ? to_f(vb[(j0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
#pragma unroll
    for (int jj = 0; jj < BKV / 4; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * ld + d];
#pragma unroll
      for (int jj = 0; jj < BKV / 4; ++jj)
        s[jj] = fmaf(qv, ks[(sub + 4 * jj) * ld + d], s[jj]);
    }

    float mx = NEG_INF;
    unsigned live = 0;  // bit jj: key sub + 4*jj is unmasked
#pragma unroll
    for (int jj = 0; jj < BKV / 4; ++jj) {
      const int kpos = j0 + sub + 4 * jj;
      float x = s[jj] * scale;
      if (cap > 0.f) x = tanhf(x / cap) * cap;
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s[jj] = ok ? x : NEG_INF;
      live |= static_cast<unsigned>(ok) << jj;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BKV / 4; ++jj) {
      const float p = ((live >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
      ps[row * (BKV + 1) + sub + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's P is written by the 4 lanes that read it

#pragma unroll
    for (int e = 0; e < DMAX / 4; ++e) acc[e] *= corr;
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = ps[row * (BKV + 1) + jj];
      const float* vr = vs + jj * ld;
#pragma unroll
      for (int e = 0; e < DMAX / 4; ++e) {
        const int d = sub + 4 * e;
        if (d < D) acc[e] = fmaf(p, vr[d], acc[e]);
      }
    }
  }

  if (qpos < Sq) {
    const float lc = fmaxf(l, 1e-20f);
    T* ob = o + b * osb + h * osh + static_cast<int64_t>(qpos) * oss;
#pragma unroll
    for (int e = 0; e < DMAX / 4; ++e) {
      const int d = sub + 4 * e;
      if (d < D) store_out(&ob[d], acc[e] / lc);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, const int64_t* st,
           float scale, int causal, int window, float cap, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(B) * Hq,
            static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_fwd<T, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, const int64_t* st,
             float scale, int causal, int window, float cap,
             cudaStream_t s) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, scale,
                         causal, window, cap, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, scale,
                          causal, window, cap, s);
  return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, scale,
                        causal, window, cap, s);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D], o like q, each given by its
// (batch, head, seq) element strides with unit stride on D.  window <= 0:
// no window; cap <= 0: no soft-cap.  Returns cudaGetLastError() after the
// launch (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, int64_t qsb, int64_t qsh, int64_t qss,
                           int64_t ksb, int64_t ksh, int64_t kss,
                           int64_t vsb, int64_t vsh, int64_t vss,
                           int64_t osb, int64_t osh, int64_t oss,
                           float scale, int causal, int window, float cap,
                           int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv < 0 || D <= 0 || D > 256 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                          vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_d<bf16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, scale,
                          causal, window, cap, s);
  if (dtype == kF32)
    return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, scale,
                           causal, window, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
