// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention): online-softmax attention
// with GQA head groups, a causal mask, a sliding window (qpos - kpos <
// window), tanh soft-capping of the scaled logits, NEG_INF = -1e30 masking
// with masked probabilities selected to 0 and the row sum clamped at 1e-20
// (a fully masked row gives 0 and an LSE of about -1e30), and key tiles
// above the causal diagonal or outside the window skipped.  Query row r sits at
// position r + q_offset and key c at c: q_offset 0 is the Pallas kernel's
// top-left alignment, and a ring attention round passes its first query's
// global position less its first key's, so both masks compare global
// positions (q_offset >= 0; a query tile whose key range comes out empty
// loads no tile and writes zeros).  Any batch/head/sequence strides (unit
// stride on D), so [B, S, H, D] activations are read in place, and the
// output is written in q's layout.
//
// What bounds it on this card: at the main paths' prefill shapes (bf16,
// causal; deepseek-7b [4, 32, 128, 128], zamba2-2.7b [4, 32, 512, 80]) a
// launch does 32 and 128 operations per byte it must move, below the H100's
// ~295 operations/byte balance point, so its floor is memory traffic
// (5 us and 12.5 us); in practice it is bound by latency: each block's
// chain of dependent tile loads, products and softmax steps.
//
// Two paths, chosen by the wrapper (kernels/flash_attention/ops.py:_path)
// and refused here (cudaErrorInvalidValue) if the dtype does not match:
//   * mma (bf16), after FlashAttention-2: one 128-thread block per
//     (batch * q-head, 64-row query tile), heaviest tiles first;
//     each warp owns 16 query rows.  Both products run on the tensor cores
//     with mma.sync.m16n8k16 (bf16 in, fp32 out): S = Q K^T and O += P V
//     keep S, P and O in registers, which wgmma (accumulators of 64-row
//     warpgroup tiles, B from shared memory) would not at these small
//     tiles; the bound is bytes and latency, not tensor-core rate.  Q is
//     read once into registers with ldmatrix (re-read from shared memory
//     at D 256 to fit registers); K and V tiles (64 keys, 32 at D 256)
//     stay bf16 in shared memory with a 16-byte row pad, so ldmatrix (K)
//     and ldmatrix.trans (V) are conflict-free, and are double-buffered
//     with 16-byte cp.async so tile j + 1 loads while tile j computes
//     (masked scalar loads into the same layout where rows are not
//     16-byte aligned).  Scale, cap and, only on tiles that cross the
//     diagonal, the window edge or Skv, the masks apply to S in registers;
//     row max and sum combine across a quad with shfl_xor 1 and 2.  P is
//     rounded to bf16, as the TPU kernel casts p to v's dtype, and two
//     adjacent n8 accumulator tiles of S form one k16 A fragment of P V.
//     The head dim is padded with zeros to 64, 80, 96, 128 or 256.
//   * simt (fp32): the CUDA-core kernel, fp32 FMAs from shared memory, so
//     fp32 results are true fp32 products: one 128-thread block per
//     (batch * q-head, 32-row query tile), four threads a row, Q, K and V
//     converted to fp32 in shared memory with a padded pitch (D + 1).
//
// The backward (flash_attention_bwd_launch) is csrc/flash_attention_bwd.cu.

#include "flash_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 path: CUDA-core SIMT, true fp32 products
// ---------------------------------------------------------------------------

constexpr int BQ = 32;    // query rows per block
constexpr int BKV = 32;   // keys per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
         (static_cast<size_t>(BQ) * ld + 2 * static_cast<size_t>(BKV) * ld +
          static_cast<size_t>(BQ) * (BKV + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
              int D, int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
              int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
              int64_t vss, int64_t osb, int64_t osh, int64_t oss,
              float scale, int causal, int window, int q_offset, float cap) {
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
  const int qrow = q0 + row;           // this thread's query row
  const int qpos = qrow + q_offset;    // and its position for the masks

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
  int k_begin, k_end;
  key_range(q0 + q_offset, min(BQ, Sq - q0), Skv, causal, window, BKV,
            &k_begin, &k_end);

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

  if (qrow < Sq) {
    const float lc = fmaxf(l, 1e-20f);
    if (lse != nullptr && sub == 0)  // a row that saw no key: -1e30
      lse[static_cast<int64_t>(bh) * Sq + qrow] = m + logf(lc);
    T* ob = o + b * osb + h * osh + static_cast<int64_t>(qrow) * oss;
#pragma unroll
    for (int e = 0; e < DMAX / 4; ++e) {
      const int d = sub + 4 * e;
      if (d < D) store_out(&ob[d], acc[e] / lc);
    }
  }
}

template <int DMAX>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                const int64_t* st, float scale, int causal, int window,
                int q_offset, float cap, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<float, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(B) * Hq,
            static_cast<unsigned>((Sq + BQ - 1) / BQ));
  flash_fwd<float, DMAX><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv,
      Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal, window, q_offset, cap);
  return static_cast<int>(cudaGetLastError());
}

int launch_simt_d(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                  const int64_t* st, float scale, int causal, int window,
                  int q_offset, float cap, cudaStream_t s) {
  if (D <= 64)
    return launch_simt<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                           scale, causal, window, q_offset, cap, s);
  if (D <= 128)
    return launch_simt<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                            scale, causal, window, q_offset, cap, s);
  return launch_simt<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st,
                          scale, causal, window, q_offset, cap, s);
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync m16n8k16 tensor cores
// ---------------------------------------------------------------------------

constexpr int MQ = 64;  // query rows per block: 16 per warp

template <int DP, int BK>
constexpr size_t mma_smem() {
  return sizeof(bf16) * pitch<DP>() * (MQ + 4 * BK);
}

// One 128-thread block per (batch * q-head, 64-row query tile); warp w owns
// rows 16 w .. 16 w + 15.  DP: head dim padded to a multiple of 16; BK: keys
// per tile; QREG: Q fragments held in registers (else re-read from smem).
// OFFSET: the launch's q_offset is not 0.  At offset 0 (every launch but a
// ring round the window cuts) the kernel compiles to the offset-free code,
// whose register allocation the offset's bookkeeping would otherwise move:
// measured, that cost seamless's D-64 cross attention 26 % (PERF.md §6).
template <int DP, int BK, bool QREG, bool VEC, bool OFFSET>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
              int D, int64_t qsb, int64_t qsh,
              int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
              int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
              int64_t osh, int64_t oss, float scale, int causal, int window,
              int q_offset, float cap) {
  constexpr int LD = pitch<DP>();
  constexpr int NT = BK / 8;   // key n8 tiles of S
  constexpr int DT = DP / 8;   // d n8 tiles of O
  constexpr int KD = DP / 16;  // k16 steps of Q K^T
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [MQ][LD]
  bf16* ks = qs + MQ * LD;                       // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                   // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);  // GQA: kv head of this q head
  const int off = OFFSET ? q_offset : 0;
  // heaviest tiles first: the last query tile sees the most keys under a
  // causal mask at offset 0; under an offset the first one may, where the
  // window start moves past more keys than the causal end adds (a ring
  // round under a window), so the end whose key range is longer goes first
  int q0, k_begin, k_end;
  if constexpr (OFFSET) {
    const int last = gridDim.y - 1, y = blockIdx.y;
    int b0, e0, b1, e1;
    key_range(off, min(MQ, Sq), Skv, causal, window, BK, &b0, &e0);
    key_range(last * MQ + off, Sq - last * MQ, Skv, causal, window, BK, &b1,
              &e1);
    q0 = (e1 - b1 >= e0 - b0 ? last - y : y) * MQ;
    key_range(q0 + off, min(MQ, Sq - q0), Skv, causal, window, BK, &k_begin,
              &k_end);
  } else {
    q0 = (gridDim.y - 1 - blockIdx.y) * MQ;
    k_end = Skv;
    if (causal) k_end = min(Skv, min(q0 + MQ, Sq));
    k_begin = 0;
    if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  }
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const int p0 = q0 + off;  // the tile's first position

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  load_tile<DP, MQ, VEC>(qs, qb, q0, Sq, D, qss);
  cp_async_commit();
  if (k_begin < k_end) {
    load_tile<DP, BK, VEC>(ks, kb, k_begin, Skv, D, kss);
    load_tile<DP, BK, VEC>(vs, vb, k_begin, Skv, D, vss);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                              (lane / 16) * 8);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  int buf = 0;
  for (int j0 = k_begin; j0 < k_end; j0 += BK, buf ^= 1) {
    if (j0 + BK < k_end) {  // next tile loads while this one computes
      load_tile<DP, BK, VEC>(ks + (buf ^ 1) * BK * LD, kb, j0 + BK, Skv, D,
                             kss);
      load_tile<DP, BK, VEC>(vs + (buf ^ 1) * BK * LD, vb, j0 + BK, Skv, D,
                             vss);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * BK * LD;
    const bf16* vt = vs + buf * BK * LD;

    // S = Q K^T: K rows are keys with d contiguous, i.e. the "col" B
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                           (lane / 16) * 8);
      }
#pragma unroll
      for (int t2 = 0; t2 < NT / 2; ++t2) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, kt + (t2 * 16 + (lane / 16) * 8 + lane % 8) * LD +
                             kk * 16 + ((lane / 8) % 2) * 8);
        mma_16816(s[2 * t2], a, bfr[0], bfr[1]);
        mma_16816(s[2 * t2 + 1], a, bfr[2], bfr[3]);
      }
    }

    // scale, cap and (only on tiles that cross an edge) mask, in log2 units
    const bool need_mask = j0 + BK > Skv || (causal && j0 + BK - 1 > p0) ||
                           (window > 0 && p0 + MQ - 1 - j0 >= window);
    uint32_t live = 0xffffffffu;  // bit 4 t + e: element s[t][e] unmasked
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale;
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        x *= LOG2E;
        if (need_mask) {
          const int kpos = j0 + t * 8 + 2 * (lane % 4) + (e & 1);
          const int qpos = (e < 2 ? row_lo : row_hi) + off;
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          if (!ok) {
            x = NEG_INF;
            live &= ~(1u << (4 * t + e));
          }
        }
        s[t][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked probabilities are selected to 0, never left to underflow
        const float p =
            ((live >> (4 * t + e)) & 1u) ? exp2f(s[t][e] - m[e / 2]) : 0.f;
        s[t][e] = p;
        l[e / 2] += p;  // this thread's part of the row sum, fp32
      }
    }
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }

    // O += P V: P is rounded to bf16 (as the TPU kernel casts p to v's
    // dtype) and two adjacent n8 accumulator tiles form one k16 A fragment;
    // V rows are keys with d contiguous, so ldmatrix.trans gives the B
#pragma unroll
    for (int t2 = 0; t2 < NT / 2; ++t2) {
      const uint32_t a[4] = {pack_bf16(s[2 * t2][0], s[2 * t2][1]),
                             pack_bf16(s[2 * t2][2], s[2 * t2][3]),
                             pack_bf16(s[2 * t2 + 1][0], s[2 * t2 + 1][1]),
                             pack_bf16(s[2 * t2 + 1][2], s[2 * t2 + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, vt + (t2 * 16 + ((lane / 8) % 2) * 8 +
                                     lane % 8) * LD +
                                   dp * 16 + (lane / 16) * 8);
        mma_16816(acc[2 * dp], a, bfr[0], bfr[1]);
        mma_16816(acc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other buffer
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-20f);  // a fully masked row gives 0
  }
  if (lse != nullptr && lane % 4 == 0) {  // natural log: m is in log2 units
    float* lb = lse + static_cast<int64_t>(bh) * Sq;
    if constexpr (OFFSET) {  // a row that saw no key: -1e30
      if (row_lo < Sq)
        lb[row_lo] = m[0] == NEG_INF
                         ? NEG_INF
                         : (m[0] + log2f(fmaxf(l[0], 1e-20f))) / LOG2E;
      if (row_hi < Sq)
        lb[row_hi] = m[1] == NEG_INF
                         ? NEG_INF
                         : (m[1] + log2f(fmaxf(l[1], 1e-20f))) / LOG2E;
    } else {  // (at offset 0 only a window without the causal mask leaves
              // one, at (-1e30 + log2 1e-20) / log2 e)
      if (row_lo < Sq)
        lb[row_lo] = (m[0] + log2f(fmaxf(l[0], 1e-20f))) / LOG2E;
      if (row_hi < Sq)
        lb[row_hi] = (m[1] + log2f(fmaxf(l[1], 1e-20f))) / LOG2E;
    }
  }
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int col = t * 8 + 2 * (lane % 4);
    if (col < D) {
      const bool two = col + 1 < D;
      if (row_lo < Sq)
        store_pair_bf16(ob + row_lo * oss + col, acc[t][0] * inv[0],
                        acc[t][1] * inv[0], two, VEC);
      if (row_hi < Sq)
        store_pair_bf16(ob + row_hi * oss + col, acc[t][2] * inv[1],
                        acc[t][3] * inv[1], two, VEC);
    }
  }
}

template <int DP, int BK, bool QREG>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
               const int64_t* st, float scale, int causal, int window,
               int q_offset, float cap, bool vec, cudaStream_t s) {
  auto kern = q_offset != 0
                  ? (vec ? flash_mma<DP, BK, QREG, true, true>
                         : flash_mma<DP, BK, QREG, false, true>)
                  : (vec ? flash_mma<DP, BK, QREG, true, false>
                         : flash_mma<DP, BK, QREG, false, false>);
  constexpr size_t smem = mma_smem<DP, BK>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(B) * Hq,
            static_cast<unsigned>((Sq + MQ - 1) / MQ));
  kern<<<grid, MMA_THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq, Hkv, Sq,
      Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal, window, q_offset, cap);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_d(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                 const int64_t* st, float scale, int causal, int window,
                 int q_offset, float cap, cudaStream_t s) {
  // 16-byte cp.async loads and paired stores need every row 16-byte
  // aligned; otherwise the same kernel loads scalars into the same layout
  const void* ptrs[4] = {q, k, v, o};
  bool vec = D % 8 == 0;
  for (int i = 0; i < 4; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 8 == 0;
  if (D <= 64)
    return launch_mma<64, 64, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                    D, st, scale, causal, window, q_offset,
                                    cap, vec, s);
  if (D <= 80)
    return launch_mma<80, 64, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                    D, st, scale, causal, window, q_offset,
                                    cap, vec, s);
  if (D <= 96)
    return launch_mma<96, 64, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                    D, st, scale, causal, window, q_offset,
                                    cap, vec, s);
  if (D <= 128)
    return launch_mma<128, 64, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                     D, st, scale, causal, window, q_offset,
                                     cap, vec, s);
  return launch_mma<256, 32, false>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv,
                                    D, st, scale, causal, window, q_offset,
                                    cap, vec, s);
}
}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
// q: [B, Hq, Sq, D], k/v: [B, Hkv, Skv, D], o like q, each given by its
// (batch, head, seq) element strides with unit stride on D.  lse: null, or
// a contiguous fp32 [B, Hq, Sq] that receives each row's log-sum-exp of
// the scaled (and capped) logits, for the backward.  window <= 0: no
// window; cap <= 0: no soft-cap.  q_offset >= 0: query row r sits at
// position r + q_offset against key c at c in the causal and window masks
// (Sq + q_offset + 64 at most 2^31 - 1: a query tile's last position, up
// to 63 rows past Sq - 1, is an int).  path: kPathSimt (fp32) or kPathMma
// (bf16); a path whose preconditions fail returns cudaErrorInvalidValue
// without launching, else the result is cudaGetLastError() after the
// launch (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Hq, int Hkv,
                           int Sq, int Skv, int D, int64_t qsb, int64_t qsh,
                           int64_t qss, int64_t ksb, int64_t ksh,
                           int64_t kss, int64_t vsb, int64_t vsh,
                           int64_t vss, int64_t osb, int64_t osh,
                           int64_t oss, float scale, int causal, int window,
                           int q_offset, float cap, int dtype, int path,
                           void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv < 0 || D <= 0 || D > 256 || (Sq + BQ - 1) / BQ > 65535 ||
      q_offset < 0 || q_offset > INT32_MAX - 64 - Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[12] = {qsb, qsh, qss, ksb, ksh, kss,
                          vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kPathMma && dtype == kBF16)
    return launch_mma_d(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st, scale,
                        causal, window, q_offset, cap, s);
  if (path == kPathSimt && dtype == kF32)
    return launch_simt_d(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, st, scale,
                         causal, window, q_offset, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
