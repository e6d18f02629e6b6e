// Flash attention backward for Hopper (sm_90a), the backward of
// csrc/flash_attention.cu's forward kernel.
//
// The backward (flash_attention_bwd_launch) has no Pallas counterpart: the
// reference differentiates its jnp attention.  What bounds it on this card:
// at deepseek-7b's train shape ([4, 32, 512, 128] bf16, causal) its five
// products over the causal pairs take 21.5 GFLOP (22 us at 989 TFLOP/s)
// beside 0.118 GB moved once (q, k, v, dO, dQ, dK, dV and the row lse; the
// bf16 kernels do not read O), 35 us at 3.35 TB/s, so bytes bound it at
// 0.0351 ms.  mma.sync, whose warps own 16 rows, reads every B
// fragment from shared memory once a warp and stalled on that and on latency
// at ~27 % of its own rate (PERF.md §6); so at D 80 and 128 (bf16, aligned
// rows) and at D 256 both backward kernels run on wgmma: 64-row warpgroup
// tiles whose operands the tensor cores read from 128-byte-swizzled shared
// memory once for all four warps, P^T and dS (dS^T) fed from registers.  At
// D 256 the dK/dV kernel gives dV and dK, m64n256 accumulators of 128
// registers a thread each, to two warpgroups (flash_bwd_dkdv_wgmma2).  dQ is
// recomputed in its own kernel, so no atomics are needed (two launches;
// gradients bitwise repeatable).  The dQ kernel also forms delta = rowsum(dO
// O) for both, as rowsum(P dP) in fp32 over a first sweep of its key tiles:
// where scores pass a soft-cap the softmax is nearly one-hot, dS = P (dP -
// delta) cancels, and a delta from the bf16 O (or from an fp32 O whose P was
// rounded to bf16 in the forward) puts that rounding into dS.  Uncapped, a
// delta error e adds e times the P-weighted mean of K to a dQ row, which
// does not cancel as dQ's own centred sum does: a causal uncapped backward
// with delta from the bf16 O misses fp32 autograd by ~5 % of dQ's RMS
// (tests/test_torch_attn_bwd.py, nocap), so every bf16 kernel sweeps.  The
// sweep costs the dQ kernel its S and dP products again.  Under a soft-cap the
// kernels also take P and dS into their products as two bf16 terms
// (frag_bf16).  Measured (scripts/compare_backward.py, NVIDIA H100 80GB
// HBM3, 700.00 W): 0.188 ms at [4, 32, 512, 128] (0.174 with delta from the
// bf16 O), 21 % of that bound, 1.34x SDPA's backward (0.140); 0.156 ms at
// [4, 32, 512, 80] (0.131), 16 %, 1.42x SDPA (0.110); 0.227 ms at gemma-7b's
// [4, 16, 512, 256], 18 % of its bound, 1.42x SDPA (0.160), where the
// CUDA-core kernels took 7.26 ms.  What is left: each block runs its
// products, its softmax gradient and its next products in turn, and two
// blocks an SM do not hide all of it.

#include "flash_attention.cuh"

namespace {

// key_range's counterpart for a dK/dV block: the query rows [*begin,
// *end) that may see a key of a tile of `keys` keys at positions j0 .. j0 +
// keys - 1, row r sitting at r + q_offset, begin rounded down to a `tile`
// boundary: the causal start is the row at the first key's position, the
// window end the row past the last key's position plus window - 1.  Empty
// (begin >= end) where every row lies before the tile or past the window.
__device__ __forceinline__ void query_range(int j0, int keys, int Sq,
                                            int causal, int window,
                                            int q_offset, int tile,
                                            int* begin, int* end) {
  *begin = causal ? max(0, j0 - q_offset) / tile * tile : 0;
  *end = window > 0 ? static_cast<int>(min(
                          static_cast<long long>(Sq),
                          static_cast<long long>(j0) + keys - 1 + window -
                              q_offset))
                    : Sq;
}

// ---------------------------------------------------------------------------
// backward: CUDA-core SIMT, fp32
// ---------------------------------------------------------------------------
//
// After FlashAttention-2's split, without atomics, so gradients are
// deterministic: (1) delta = rowsum(dO * O); (2) dK/dV, one block per
// (batch * kv-head, 32-key tile), walking the group's q heads and the query
// tiles that can see its keys (from the causal diagonal on, up to the
// window's edge) and summing over them in registers; (3) dQ, one block per
// (batch * q-head, 32-row query tile), walking the forward's key tiles.
// Both recompute P = exp(s - lse) from the forward's row log-sum-exp,
// selected to 0 where masked (so a fully masked row gets no gradient, not
// NaN), and dS = P (dP - delta), times 1 - tanh^2(s / cap) under a
// soft-cap, times the scale.  Like the forward's SIMT path: four threads a
// row, tiles in shared memory with a padded pitch.  Under a query offset
// (a ring round's launch) both ranges and every mask compare row r at
// position r + q_offset with key c at c (key_range, query_range, live): a
// row that sees no key reads no tile and writes dQ 0, a key tile that no
// row sees reads no query tile and writes dK and dV 0, never NaN.

constexpr int BBQ = 32;  // query rows per tile
constexpr int BBK = 32;  // keys per tile


// rows [r0, r0 + ROWS) of a [S, D] matrix (row stride ld) as fp32 into a
// [ROWS][D + 1] tile, zero past S
template <int ROWS>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int r0,
                                         int S, int D, int64_t ld) {
  const int pitch = D + 1;
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * pitch + c] =
        r0 + r < S ? src[static_cast<int64_t>(r0 + r) * ld + c] : 0.f;
  }
}

// dS of one (query, key) pair from its raw product qk, dP and the row's
// lse and delta; p receives P (0 where masked)
__device__ __forceinline__ float grad_s(float qk, float dp, float lse,
                                        float delta, bool ok, float scale,
                                        float cap, float* p) {
  float x = qk * scale, dcap = 1.f;
  if (cap > 0.f) {
    const float t = tanhf(x / cap);
    x = t * cap;
    dcap = 1.f - t * t;
  }
  *p = ok ? expf(x - lse) : 0.f;
  return *p * (dp - delta) * dcap * scale;
}

// Whether query row `row` and key `kr` form an unmasked pair, in the query
// rows' frame: the backward kernels pass a key's position less the
// launch's q_offset (kpos - q_offset) and Skv - q_offset, so that row r at
// position r + q_offset and key c compare as r against c - q_offset in the
// causal and window terms (at offset 0 the plain positions)
__device__ __forceinline__ bool live(int row, int kr, int Sq, int Skr,
                                     int causal, int window) {
  bool ok = row < Sq && kr < Skr;
  if (causal) ok = ok && kr <= row;
  if (window > 0) ok = ok && (row - kr) < window;
  return ok;
}

// delta[row] = sum_d dO[row, d] O[row, d] over the B * Hq * Sq rows, one
// warp a row
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                    float* __restrict__ delta, int Hq, int Sq, int D,
                    int64_t rows, int64_t osb, int64_t osh, int64_t oss,
                    int64_t dsb, int64_t dsh, int64_t dss) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int64_t i = row % Sq, bh = row / Sq;
  const int64_t b = bh / Hq, h = bh % Hq;
  const float* orow = o + b * osb + h * osh + i * oss;
  const float* drow = dout + b * dsb + h * dsh + i * dss;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += orow[d] * drow[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

size_t bwd_smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (4 * static_cast<size_t>(BBQ) * ld +
                          2 * static_cast<size_t>(BBQ) * (BBK + 1) +
                          2 * static_cast<size_t>(BBQ));
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                   int D, int64_t qsb, int64_t qsh, int64_t qss,
                   int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
                   int64_t vsh, int64_t vss, int64_t dsb, int64_t dsh,
                   int64_t dss, int64_t dksb, int64_t dksh, int64_t dkss,
                   int64_t dvsb, int64_t dvsh, int64_t dvss, float scale,
                   int causal, int window, int q_offset, float cap) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;              // [BBK][ld]
  float* vs = ks + BBK * ld;     // [BBK][ld]
  float* qs = vs + BBK * ld;     // [BBQ][ld]
  float* dos = qs + BBQ * ld;    // [BBQ][ld]
  float* ps = dos + BBQ * ld;    // [BBK][BBQ + 1]
  float* ds_s = ps + BBK * (BBQ + 1);  // [BBK][BBQ + 1]
  float* lse_s = ds_s + BBK * (BBQ + 1);  // [BBQ]
  float* dl_s = lse_s + BBQ;             // [BBQ]

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // key row within the tile
  const int sub = tid & 3;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int j0 = blockIdx.y * BBK;
  const int kpos = j0 + row;

  load_f32<BBK>(ks, k + b * ksb + hk * ksh, j0, Skv, D, kss);
  load_f32<BBK>(vs, v + b * vsb + hk * vsh, j0, Skv, D, vss);

  float dka[DMAX / 4], dva[DMAX / 4];
#pragma unroll
  for (int e = 0; e < DMAX / 4; ++e) dka[e] = dva[e] = 0.f;

  // query tiles with an unmasked pair for some key of this tile
  int q_begin, q_end;
  query_range(j0, BBK, Sq, causal, window, q_offset, BBQ, &q_begin, &q_end);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* qb = q + b * qsb + h * qsh;
    const float* db = dout + b * dsb + h * dsh;
    const float* lb = lse + (static_cast<int64_t>(b) * Hq + h) * Sq;
    const float* deb = delta + (static_cast<int64_t>(b) * Hq + h) * Sq;
    for (int i0 = q_begin; i0 < q_end; i0 += BBQ) {
      __syncthreads();  // K, V staged / previous tile's reads done
      load_f32<BBQ>(qs, qb, i0, Sq, D, qss);
      load_f32<BBQ>(dos, db, i0, Sq, D, dss);
      if (tid < BBQ) {
        lse_s[tid] = i0 + tid < Sq ? lb[i0 + tid] : 0.f;
        dl_s[tid] = i0 + tid < Sq ? deb[i0 + tid] : 0.f;
      }
      __syncthreads();

      // this thread's key row against queries sub + 4 jj
      float s[BBQ / 4], dp[BBQ / 4];
#pragma unroll
      for (int jj = 0; jj < BBQ / 4; ++jj) s[jj] = dp[jj] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[row * ld + d], vv = vs[row * ld + d];
#pragma unroll
        for (int jj = 0; jj < BBQ / 4; ++jj) {
          s[jj] = fmaf(kv, qs[(sub + 4 * jj) * ld + d], s[jj]);
          dp[jj] = fmaf(vv, dos[(sub + 4 * jj) * ld + d], dp[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < BBQ / 4; ++jj) {
        const int i = sub + 4 * jj;
        float p;
        const float ds =
            grad_s(s[jj], dp[jj], lse_s[i], dl_s[i],
                   live(i0 + i, kpos - q_offset, Sq, Skv - q_offset, causal,
                        window),
                   scale, cap, &p);
        ps[row * (BBQ + 1) + i] = p;
        ds_s[row * (BBQ + 1) + i] = ds;
      }
      __syncwarp();  // the row's P and dS are written by the 4 lanes

      for (int i = 0; i < BBQ; ++i) {
        const float p = ps[row * (BBQ + 1) + i];
        const float ds = ds_s[row * (BBQ + 1) + i];
        const float* qr = qs + i * ld;
        const float* dr = dos + i * ld;
#pragma unroll
        for (int e = 0; e < DMAX / 4; ++e) {
          const int d = sub + 4 * e;
          if (d < D) {
            dva[e] = fmaf(p, dr[d], dva[e]);
            dka[e] = fmaf(ds, qr[d], dka[e]);
          }
        }
      }
    }
  }

  if (kpos < Skv) {
    float* dkr = dk + b * dksb + hk * dksh + static_cast<int64_t>(kpos) * dkss;
    float* dvr = dv + b * dvsb + hk * dvsh + static_cast<int64_t>(kpos) * dvss;
#pragma unroll
    for (int e = 0; e < DMAX / 4; ++e) {
      const int d = sub + 4 * e;
      if (d < D) {
        dkr[d] = dka[e];
        dvr[d] = dva[e];
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int Hq, int Hkv, int Sq, int Skv, int D, int64_t qsb,
                 int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                 int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                 int64_t dsb, int64_t dsh, int64_t dss, int64_t dqsb,
                 int64_t dqsh, int64_t dqss, float scale, int causal,
                 int window, int q_offset, float cap) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;             // [BBQ][ld]
  float* dos = qs + BBQ * ld;   // [BBQ][ld]
  float* ks = dos + BBQ * ld;   // [BBK][ld]
  float* vs = ks + BBK * ld;    // [BBK][ld]
  float* ds_s = vs + BBK * ld;  // [BBQ][BBK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;  // query row within the tile
  const int sub = tid & 3;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BBQ;
  const int qrow = q0 + row;  // at position qrow + q_offset

  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  load_f32<BBQ>(qs, q + b * qsb + h * qsh, q0, Sq, D, qss);
  load_f32<BBQ>(dos, dout + b * dsb + h * dsh, q0, Sq, D, dss);
  const int64_t r = (static_cast<int64_t>(b) * Hq + h) * Sq + qrow;
  const float my_lse = qrow < Sq ? lse[r] : 0.f;
  const float my_delta = qrow < Sq ? delta[r] : 0.f;

  float dqa[DMAX / 4];
#pragma unroll
  for (int e = 0; e < DMAX / 4; ++e) dqa[e] = 0.f;

  // the forward's key tiles
  int k_begin, k_end;
  key_range(q0 + q_offset, min(BBQ, Sq - q0), Skv, causal, window, BBK,
            &k_begin, &k_end);

  for (int j0 = k_begin; j0 < k_end; j0 += BBK) {
    __syncthreads();  // Q, dO staged / previous tile's reads done
    load_f32<BBK>(ks, kb, j0, Skv, D, kss);
    load_f32<BBK>(vs, vb, j0, Skv, D, vss);
    __syncthreads();

    float s[BBK / 4], dp[BBK / 4];
#pragma unroll
    for (int jj = 0; jj < BBK / 4; ++jj) s[jj] = dp[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * ld + d], ov = dos[row * ld + d];
#pragma unroll
      for (int jj = 0; jj < BBK / 4; ++jj) {
        s[jj] = fmaf(qv, ks[(sub + 4 * jj) * ld + d], s[jj]);
        dp[jj] = fmaf(ov, vs[(sub + 4 * jj) * ld + d], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < BBK / 4; ++jj) {
      const int j = sub + 4 * jj;
      float p;
      ds_s[row * (BBK + 1) + j] =
          grad_s(s[jj], dp[jj], my_lse, my_delta,
                 live(qrow, j0 + j - q_offset, Sq, Skv - q_offset, causal,
                      window),
                 scale, cap, &p);
    }
    __syncwarp();  // the row's dS is written by the 4 lanes that read it

    for (int j = 0; j < BBK; ++j) {
      const float ds = ds_s[row * (BBK + 1) + j];
      const float* kr = ks + j * ld;
#pragma unroll
      for (int e = 0; e < DMAX / 4; ++e) {
        const int d = sub + 4 * e;
        if (d < D) dqa[e] = fmaf(ds, kr[d], dqa[e]);
      }
    }
  }

  if (qrow < Sq) {
    float* dqr = dq + b * dqsb + h * dqsh + static_cast<int64_t>(qrow) * dqss;
#pragma unroll
    for (int e = 0; e < DMAX / 4; ++e) {
      const int d = sub + 4 * e;
      if (d < D) dqr[d] = dqa[e];
    }
  }
}

// st: the (batch, head, seq) strides of q, k, v, o, dO, dQ, dK, dV
template <int DMAX>
int launch_bwd_simt(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, int B,
                    int Hq, int Hkv, int Sq, int Skv, int D,
                    const int64_t* st, float scale, int causal, int window,
                    int q_offset, float cap, int delta_in, cudaStream_t s) {
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* O = static_cast<const float*>(o);
  const float* DO = static_cast<const float*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * Hq * Sq;
  const unsigned rblocks =
      static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32));
  cudaError_t err = cudaSuccess;
  if (!delta_in) {
    flash_bwd_delta<<<rblocks, THREADS, 0, s>>>(
        O, DO, delta, Hq, Sq, D, rows, st[9], st[10], st[11], st[12],
        st[13], st[14]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const size_t smem = bwd_smem_bytes(D);
  auto kv_kern = flash_bwd_dkdv<DMAX>;
  auto q_kern = flash_bwd_dq<DMAX>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (Skv > 0) {
    dim3 grid(static_cast<unsigned>(B) * Hkv,
              static_cast<unsigned>((Skv + BBK - 1) / BBK));
    kv_kern<<<grid, THREADS, smem, s>>>(
        Q, K, V, DO, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv),
        Hq, Hkv, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[12], st[13], st[14], st[18], st[19],
        st[20], st[21], st[22], st[23], scale, causal, window, q_offset,
        cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(B) * Hq,
            static_cast<unsigned>((Sq + BBQ - 1) / BBQ));
  q_kern<<<grid, THREADS, smem, s>>>(
      Q, K, V, DO, lse, delta, static_cast<float*>(dq), Hq, Hkv, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12],
      st[13], st[14], st[15], st[16], st[17], scale, causal, window,
      q_offset, cap);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_simt_d(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int B,
                      int Hq, int Hkv, int Sq, int Skv, int D,
                      const int64_t* st, float scale, int causal, int window,
                      int q_offset, float cap, int delta_in, cudaStream_t s) {
  if (D <= 64)
    return launch_bwd_simt<64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  B, Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                  window, q_offset, cap, delta_in, s);
  if (D <= 128)
    return launch_bwd_simt<128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                   window, q_offset, cap, delta_in, s);
  return launch_bwd_simt<256>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 B, Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                 window, q_offset, cap, delta_in, s);
}

// ---------------------------------------------------------------------------
// backward, bf16 on the tensor cores (mma.sync m16n8k16, wgmma)
// ---------------------------------------------------------------------------
//
// The same split and recomputation as the SIMT backward, with every product
// on the tensor cores as in the forward's mma path, in two launches.  (1) dQ,
// one 128-thread block per (batch * q-head, 64-row query tile), warp w owning
// 16 query rows, heaviest causal tiles first.  Per 32-key tile it recomputes S
// = Q K^T and dP = dO V^T (K and V rows as the col B operand, ldmatrix) and
// P: a first sweep over the tiles sums delta = rowsum(P dP) of its rows in
// fp32 and writes it for (2), the second forms dS and dQ += dS K with dS
// rounded to bf16 as the A fragment (two adjacent n8 accumulator tiles make
// one k16 fragment) and K through ldmatrix.trans.  K and V tiles are
// double-buffered with cp.async: tile j + 1 loads while tile j computes.  (2)
// dK/dV, one block per (batch * kv-head, 64-key tile), warp w owning 16 keys,
// walking (group head, query tile) with Q, dO and the tile's lse and delta
// double-buffered the same way; each step is one or two 32-query halves of
// S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q (P^T and
// dS^T rounded to bf16, dO and Q through ldmatrix.trans).  The soft-cap is a
// template flag, so the common uncapped kernels carry no tanh code, and the
// softmax scale multiplies dQ and dK once at the end.  No atomics: dQ is
// recomputed rather than summed across key tiles, so the gradients are
// deterministic.  Tiles are loaded with 16-byte cp.async where rows are
// 16-byte aligned, else with masked scalar loads into the same layout; the
// accumulators stay fp32.  A query offset shifts the key and query ranges,
// the edge-tile tests and the masks as in the SIMT kernels (the keys in
// the rows' frame, j0 - q_offset); the dQ kernels and the mma.sync dK/dV
// kernels at three blocks an SM read it in their delta_in instances only
// (launch_bwd_mma).

// At D 256 (to which 128 < D < 256 is padded; any row alignment) and at
// D 80 and 128 with 16-byte aligned rows both kernels run on wgmma
// (below); otherwise on mma.sync, with tile shapes chosen by measurement
// on the H100 (PERF.md §6): dQ walks 32-key tiles at three blocks an SM;
// dK/dV steps over 32 query rows at three blocks an SM for D <= 80, over
// 64 rows at D 96 and 128 (whose dK and dV take 128 registers a thread,
// so three blocks would spill).
constexpr int BQ_M = 64;  // dQ: query rows per block
constexpr int BK_Q = 32;  // dQ: keys per tile
constexpr int BK_M = 64;  // dK/dV: keys per block
constexpr int BQ_S = 32;  // dK/dV: the query columns of one S^T half

// 2^x by ex2.approx (~2^-22 relative error, 0 at -inf): a probability of
// P, which is rounded to bf16 before any product
__device__ __forceinline__ float bwd_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An mma A fragment of 8 fp32 values (4 pairs along k) rounded to bf16
// (hi), and what that rounding left, rounded again (lo).  Under a
// soft-cap the gradients' sums cancel (a nearly one-hot softmax, the cap's
// derivative near 0), so one bf16 rounding of P or dS shows in them: the
// capped kernels take a product with hi and one with lo, whose sum keeps
// 16 of fp32's 24 bits.
__device__ __forceinline__ void frag_bf16(const float* v, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(v[2 * i] - __low2float(h),
                      v[2 * i + 1] - __high2float(h));
  }
}

// the sum of x over the four lanes of a quad (the lanes that hold one
// accumulator row)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// dK/dV: query rows per step, and blocks an SM
template <int DP>
__host__ __device__ constexpr int kv_rows() {
  return DP <= 80 ? 32 : 64;
}
template <int DP>
__host__ __device__ constexpr int kv_blocks() {
  return DP <= 80 ? 3 : 1;
}

// dQ: Q and dO of 64 rows and two buffers of K and V of BK rows
template <int DP, int BK>
constexpr size_t dq_smem() {
  return sizeof(bf16) * pitch<DP>() * (2 * BQ_M + 4 * BK);
}

// dK/dV: K and V of 64 rows, two buffers of Q and dO of QT rows and of
// their lse and delta
template <int DP, int QT>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * pitch<DP>() * (2 * BK_M + 4 * QT) +
         sizeof(float) * 4 * QT;
}

// BK: keys per tile; CAP: a soft-cap is given
// DIN: delta comes from outside (the launcher's delta_in), and with it the
// launch's q_offset (else taken as 0; see launch_bwd_mma)
template <int DP, bool VEC, int BK, bool CAP, bool DIN>
__global__ void __launch_bounds__(MMA_THREADS, 3)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     float* __restrict__ delta, bf16* __restrict__ dq,
                     int Hq, int Hkv, int Sq, int Skv, int D, int64_t qsb,
                     int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                     int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                     int64_t dsb, int64_t dsh, int64_t dss, int64_t dqsb,
                     int64_t dqsh, int64_t dqss, float scale, int causal,
                     int window, int q_offset, float cap) {
  constexpr int LD = pitch<DP>();
  constexpr int NT = BK / 8;  // key n8 tiles of S
  constexpr int DT = DP / 8;    // d n8 tiles of dQ
  const float scale_log2 = scale * LOG2E;
  constexpr int KD = DP / 16;   // k16 steps over d
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dos = qs + BQ_M * LD;                    // [64][LD]
  bf16* ks = dos + BQ_M * LD;                    // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                 // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  // heaviest causal tiles first: the last query tile sees the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_M;
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const int off = DIN ? q_offset : 0;
  const int p0 = q0 + off;  // the tile's first position

  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  load_tile<DP, BQ_M, VEC>(qs, q + b * qsb + h * qsh, q0, Sq, D, qss);
  load_tile<DP, BQ_M, VEC>(dos, dout + b * dsb + h * dsh, q0, Sq, D, dss);
  cp_async_commit();

  // the forward's key tiles (none where every key lies past the causal end
  // or before the window: the rows' dQ is 0)
  int k_begin, k_end;
  key_range(p0, min(BQ_M, Sq - q0), Skv, causal, window, BK, &k_begin,
            &k_end);
  if (k_begin < k_end) {
    load_tile<DP, BK, VEC>(ks, kb, k_begin, Skv, D, kss);
    load_tile<DP, BK, VEC>(vs, vb, k_begin, Skv, D, vss);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();

  // per row: lse in log2 units, and delta = rowsum(P dP), summed in fp32
  // over the first sweep (0 past Sq: those rows' P is masked to 0)
  const int64_t bhq = static_cast<int64_t>(b) * Hq + h;
  const float* lb = lse + bhq * Sq;
  const float l2[2] = {row_lo < Sq ? lb[row_lo] * LOG2E : 0.f,
                       row_hi < Sq ? lb[row_hi] * LOG2E : 0.f};
  float dl[2] = {0.f, 0.f};

  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // sweep 0 forms delta, sweep 1 dQ; each recomputes S, dP and P per tile.
  // With DIN the caller's delta is read and sweep 0 does not run: the
  // first tile's load is already in flight, as at sweep 0's start
  if (DIN) {
    if (row_lo < Sq) dl[0] = delta[bhq * Sq + row_lo];
    if (row_hi < Sq) dl[1] = delta[bhq * Sq + row_hi];
  }
  for (int sweep = DIN ? 1 : 0; sweep < 2; ++sweep) {
    if (sweep == 1 && !DIN) {
      dl[0] = quad_sum(dl[0]);
      dl[1] = quad_sum(dl[1]);
      if (lane % 4 == 0) {  // for the dK/dV kernel
        if (row_lo < Sq) delta[bhq * Sq + row_lo] = dl[0];
        if (row_hi < Sq) delta[bhq * Sq + row_hi] = dl[1];
      }
      if (k_begin < k_end) {  // the first tile again (all reads are done)
        load_tile<DP, BK, VEC>(ks, kb, k_begin, Skv, D, kss);
        load_tile<DP, BK, VEC>(vs, vb, k_begin, Skv, D, vss);
      }
      cp_async_commit();
    }
    int buf = 0;
    for (int j0 = k_begin; j0 < k_end; j0 += BK, buf ^= 1) {
      if (j0 + BK < k_end) {  // the next tile loads while this one computes
        load_tile<DP, BK, VEC>(ks + (buf ^ 1) * BK * LD, kb, j0 + BK,
                                 Skv, D, kss);
        load_tile<DP, BK, VEC>(vs + (buf ^ 1) * BK * LD, vb, j0 + BK,
                                 Skv, D, vss);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* kt = ks + buf * BK * LD;
      const bf16* vt = vs + buf * BK * LD;

      // S = Q K^T and dP = dO V^T: K and V rows are the col B operands
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ao[4];
        const int a_off = (warp * 16 + lane % 16) * LD + kk * 16 +
                          (lane / 16) * 8;
        ldmatrix_x4(aq, qs + a_off);
        ldmatrix_x4(ao, dos + a_off);
#pragma unroll
        for (int t2 = 0; t2 < NT / 2; ++t2) {
          const int b_off = (t2 * 16 + (lane / 16) * 8 + lane % 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t bfr[4];
          ldmatrix_x4(bfr, kt + b_off);
          mma_16816(s[2 * t2], aq, bfr[0], bfr[1]);
          mma_16816(s[2 * t2 + 1], aq, bfr[2], bfr[3]);
          ldmatrix_x4(bfr, vt + b_off);
          mma_16816(dp[2 * t2], ao, bfr[0], bfr[1]);
          mma_16816(dp[2 * t2 + 1], ao, bfr[2], bfr[3]);
        }
      }

      const bool need_mask = j0 + BK > Skv || q0 + BQ_M > Sq ||
                             (causal && j0 + BK - 1 > p0) ||
                             (window > 0 && p0 + BQ_M - 1 - j0 >= window);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x2, dcap = 1.f;  // the scaled (and capped) logit, log2 units
          if (CAP) {
            const float th = tanhf(s[t][e] * scale / cap);
            x2 = th * cap * LOG2E;
            dcap = 1.f - th * th;
          } else {
            x2 = s[t][e] * scale_log2;
          }
          bool ok = true;
          if (need_mask)
            ok = live(e < 2 ? row_lo : row_hi,
                      j0 - off + t * 8 + 2 * (lane % 4) + (e & 1), Sq,
                      Skv - off, causal, window);
          const float p = ok ? bwd_exp2(x2 - l2[e / 2]) : 0.f;
          if (sweep == 0) dl[e / 2] += p * dp[t][e];
          s[t][e] = p * (dp[t][e] - dl[e / 2]) * dcap;  // dS / scale
        }
      }
      if (sweep == 0) {
        __syncthreads();  // the next iteration refills the other buffer
        continue;
      }

      // dQ += dS K: dS rounded to bf16 as the A fragment (under a cap also
      // the remainder, frag_bf16), K via ldmatrix.trans
#pragma unroll
      for (int t2 = 0; t2 < NT / 2; ++t2) {
        uint32_t a[4], alo[4];
        frag_bf16(&s[2 * t2][0], a, alo);
#pragma unroll
        for (int d2 = 0; d2 < DP / 16; ++d2) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, kt + (t2 * 16 + ((lane / 8) % 2) * 8 +
                                       lane % 8) * LD +
                                     d2 * 16 + (lane / 16) * 8);
          mma_16816(acc[2 * d2], a, bfr[0], bfr[1]);
          mma_16816(acc[2 * d2 + 1], a, bfr[2], bfr[3]);
          if (CAP) {
            mma_16816(acc[2 * d2], alo, bfr[0], bfr[1]);
            mma_16816(acc[2 * d2 + 1], alo, bfr[2], bfr[3]);
          }
        }
      }
      __syncthreads();  // the next iteration refills the other buffer
    }
    cp_async_wait<0>();
  }

  bf16* ob = dq + b * dqsb + h * dqsh;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int col = t * 8 + 2 * (lane % 4);
    if (col < D) {
      const bool two = col + 1 < D;
      if (row_lo < Sq)
        store_pair_bf16(ob + row_lo * dqss + col, acc[t][0] * scale,
                        acc[t][1] * scale, two, VEC);
      if (row_hi < Sq)
        store_pair_bf16(ob + row_hi * dqss + col, acc[t][2] * scale,
                        acc[t][3] * scale, two, VEC);
    }
  }
}

// QT: query rows per step; CAP: a soft-cap is given; OFF: the launch's
// q_offset is read (else taken as 0): at three blocks an SM (DP <= 80) a
// thread has 170 registers, and reading the offset at run time slowed
// seamless's D-64 own-delta rows by 2.0-2.6 % (scripts/compare_backward.py,
// PERF.md section 6), so there only the delta_in instances read it; the
// other dK/dV kernels, wgmma's among them, always read it (within 1.2 %)
template <int DP, bool VEC, int QT, bool CAP, bool OFF>
__global__ void __launch_bounds__(MMA_THREADS, kv_blocks<DP>())
    flash_bwd_dkdv_mma(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
                       int Hkv, int Sq, int Skv, int D, int64_t qsb,
                       int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                       int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                       int64_t dsb, int64_t dsh, int64_t dss, int64_t dksb,
                       int64_t dksh, int64_t dkss, int64_t dvsb,
                       int64_t dvsh, int64_t dvss, float scale, int causal,
                       int window, int q_offset, float cap) {
  constexpr int LD = pitch<DP>();
  constexpr int NQ = BQ_S / 8;  // query n8 tiles of an S^T half
  constexpr int DT = DP / 8;
  const float scale_log2 = scale * LOG2E;
  constexpr int KD = DP / 16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* vs = ks + BK_M * LD;                     // [64][LD]
  bf16* qs = vs + BK_M * LD;                     // [2][QT][LD]
  bf16* dos = qs + 2 * QT * LD;                // [2][QT][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * QT * LD);  // [2][QT]
  float* dls = lses + 2 * QT;                                 // [2][QT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int j0 = blockIdx.y * BK_M;  // the first key tiles see most rows
  const int key_lo = j0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
  // the keys in the query rows' frame (position less q_offset: live)
  const int off = OFF ? q_offset : 0;
  const int j0r = j0 - off;

  load_tile<DP, BK_M, VEC>(ks, k + b * ksb + hk * ksh, j0, Skv, D, kss);
  load_tile<DP, BK_M, VEC>(vs, v + b * vsb + hk * vsh, j0, Skv, D, vss);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  // query tiles with an unmasked pair for some key of this tile, for
  // each head of the group: the block's steps (none: dK and dV are 0)
  int q_begin, q_end;
  query_range(j0, BK_M, Sq, causal, window, off, QT, &q_begin, &q_end);
  const int nqt = q_end > q_begin ? (q_end - q_begin + QT - 1) / QT : 0;
  const int n_steps = G * nqt;

  // Q, dO, lse and delta of step `it` into buffer `buf`
  auto issue = [&](int it, int buf) {
    const int h = hk * G + it / nqt;
    const int i0 = q_begin + (it % nqt) * QT;
    load_tile<DP, QT, VEC>(qs + buf * QT * LD, q + b * qsb + h * qsh, i0,
                           Sq, D, qss);
    load_tile<DP, QT, VEC>(dos + buf * QT * LD, dout + b * dsb + h * dsh,
                           i0, Sq, D, dss);
    const int t = threadIdx.x % QT;  // threads [0, QT) lse, [QT, 2 QT) delta
    if (threadIdx.x < 2 * QT) {
      const float* src = (threadIdx.x < QT ? lse : delta) +
                         (static_cast<int64_t>(b) * Hq + h) * Sq;
      float* dst = (threadIdx.x < QT ? lses : dls) + buf * QT + t;
      const bool ok = i0 + t < Sq;
      cp_async4(dst, ok ? src + i0 + t : src, ok);
    }
  };
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();

  for (int it = 0; it < n_steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_steps) {  // the next step loads while this one computes
      issue(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = q_begin + (it % nqt) * QT;
    const bf16* qt = qs + buf * QT * LD;
    const bf16* dt = dos + buf * QT * LD;
    const float* lt = lses + buf * QT;
    const float* dlt = dls + buf * QT;

#pragma unroll
    for (int half = 0; half < QT / BQ_S; ++half) {
      const int i0s = i0 + half * BQ_S;  // this half's first query
      if (i0s >= q_end || (causal && i0s + BQ_S - 1 < j0r)) continue;
      const bf16* qh = qt + half * BQ_S * LD;
      const bf16* dh = dt + half * BQ_S * LD;

      // S^T = K Q^T and dP^T = V dO^T: K and V rows the A operand, Q and
      // dO rows the col B operand
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        const int a_off = (warp * 16 + lane % 16) * LD + kk * 16 +
                          (lane / 16) * 8;
        ldmatrix_x4(ak, ks + a_off);
        ldmatrix_x4(av, vs + a_off);
#pragma unroll
        for (int t2 = 0; t2 < NQ / 2; ++t2) {
          const int b_off = (t2 * 16 + (lane / 16) * 8 + lane % 8) * LD +
                            kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t bfr[4];
          ldmatrix_x4(bfr, qh + b_off);
          mma_16816(st[2 * t2], ak, bfr[0], bfr[1]);
          mma_16816(st[2 * t2 + 1], ak, bfr[2], bfr[3]);
          ldmatrix_x4(bfr, dh + b_off);
          mma_16816(dpt[2 * t2], av, bfr[0], bfr[1]);
          mma_16816(dpt[2 * t2 + 1], av, bfr[2], bfr[3]);
        }
      }

      const bool need_mask = j0 + BK_M > Skv || i0s + BQ_S > Sq ||
                             (causal && i0s < j0r + BK_M - 1) ||
                             (window > 0 && i0s + BQ_S - 1 - j0r >= window);
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = half * BQ_S + t * 8 + 2 * (lane % 4) + (e & 1);
          float x2, dcap = 1.f;  // the scaled (and capped) logit, log2
          if (CAP) {
            const float th = tanhf(st[t][e] * scale / cap);
            x2 = th * cap * LOG2E;
            dcap = 1.f - th * th;
          } else {
            x2 = st[t][e] * scale_log2;
          }
          bool ok = true;
          if (need_mask)
            ok = live(i0 + col, (e < 2 ? key_lo : key_hi) - off, Sq,
                      Skv - off, causal, window);
          const float p = ok ? bwd_exp2(x2 - lt[col] * LOG2E) : 0.f;
          st[t][e] = p;                                    // P^T
          dpt[t][e] = p * (dpt[t][e] - dlt[col]) * dcap;  // dS^T / scale
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 as
      // A fragments (under a cap also the remainders, frag_bf16), dO and Q
      // through ldmatrix.trans
#pragma unroll
      for (int t2 = 0; t2 < NQ / 2; ++t2) {
        uint32_t ap[4], aplo[4], ad[4], adlo[4];
        frag_bf16(&st[2 * t2][0], ap, aplo);
        frag_bf16(&dpt[2 * t2][0], ad, adlo);
#pragma unroll
        for (int d2 = 0; d2 < DP / 16; ++d2) {
          const int b_off = (t2 * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                            d2 * 16 + (lane / 16) * 8;
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, dh + b_off);
          mma_16816(dva[2 * d2], ap, bfr[0], bfr[1]);
          mma_16816(dva[2 * d2 + 1], ap, bfr[2], bfr[3]);
          if (CAP) {
            mma_16816(dva[2 * d2], aplo, bfr[0], bfr[1]);
            mma_16816(dva[2 * d2 + 1], aplo, bfr[2], bfr[3]);
          }
          ldmatrix_x4_trans(bfr, qh + b_off);
          mma_16816(dka[2 * d2], ad, bfr[0], bfr[1]);
          mma_16816(dka[2 * d2 + 1], ad, bfr[2], bfr[3]);
          if (CAP) {
            mma_16816(dka[2 * d2], adlo, bfr[0], bfr[1]);
            mma_16816(dka[2 * d2 + 1], adlo, bfr[2], bfr[3]);
          }
        }
      }
    }
    __syncthreads();  // the next step refills the other buffer
  }
  cp_async_wait<0>();

  bf16* kob = dk + b * dksb + hk * dksh;
  bf16* vob = dv + b * dvsb + hk * dvsh;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int col = t * 8 + 2 * (lane % 4);
    if (col < D) {
      const bool two = col + 1 < D;
      if (key_lo < Skv) {
        store_pair_bf16(kob + key_lo * dkss + col, dka[t][0] * scale,
                        dka[t][1] * scale, two, VEC);
        store_pair_bf16(vob + key_lo * dvss + col, dva[t][0], dva[t][1], two,
                        VEC);
      }
      if (key_hi < Skv) {
        store_pair_bf16(kob + key_hi * dkss + col, dka[t][2] * scale,
                        dka[t][3] * scale, two, VEC);
        store_pair_bf16(vob + key_hi * dvss + col, dva[t][2], dva[t][3], two,
                        VEC);
      }
    }
  }
}

// dK/dV on wgmma at D 80 and 128 (DP), for 16-byte aligned rows.  One
// warpgroup (128 threads) per (batch * kv-head, 64-key tile): the 64 keys
// are the M of every product, so each Q, dO, K and V element in shared
// memory is read once by the tensor cores for all four warps (mma.sync
// reads every B fragment once a warp).  Per step (group head, 64-row query
// tile): S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major
// from shared memory), P^T and dS^T in registers as in the mma.sync
// kernel, then dV += P^T dO and dK += dS^T Q (m64n{DP}k16 with A from
// registers, dO and Q MN-major).  Tiles are [2 chunks of 64 columns][64
// rows] with the 128-byte swizzle (zero past D), loaded by 16-byte
// cp.async; Q, dO, lse and delta are double-buffered across steps.  Two
// blocks an SM.
constexpr int SW_TILE = 64 * 128 * 2;  // one [64][128] bf16 tile, 16 KB

// bytes of a swizzled tile of 64 rows and DP columns: 64-column chunks of
// 8 KB (16 KB at DP 80 and 128, 32 KB at 256)
template <int DP>
__host__ __device__ constexpr int sw_tile() {
  return (DP + 63) / 64 * 8192;
}

// byte offset of row r's 16-byte piece c (0 .. 8 * chunks - 1) in a
// swizzled tile
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows [r0, r0 + 64) of a [S, D] bf16 matrix (row stride ld) into a
// swizzled tile of NCH chunks, zero past S and past D, by NT threads:
// 16-byte cp.async where rows are 16-byte aligned (VEC), else scalar loads
// into the same layout (the reader's proxy fence covers both)
template <int NCH = 2, int NT = MMA_THREADS, bool VEC = true>
__device__ __forceinline__ void load_sw(uint8_t* dst, const bf16* src,
                                        int r0, int S, int D, int64_t ld) {
  for (int e = threadIdx.x; e < 64 * 8 * NCH; e += NT) {
    const int r = e / (8 * NCH), c = e % (8 * NCH);
    const bool in_row = r0 + r < S;
    const bf16* g = src + static_cast<int64_t>(r0 + r) * ld + c * 8;
    if (VEC) {
      const bool ok = in_row && c * 8 < D;
      cp_async16(dst + sw128(r, c), ok ? g : src, ok);
    } else {
      bf16* d = reinterpret_cast<bf16*>(dst + sw128(r, c));
#pragma unroll
      for (int x = 0; x < 8; ++x)
        d[x] = (in_row && c * 8 + x < D) ? g[x] : __float2bfloat16(0.f);
    }
  }
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    flash_bwd_dkdv_wgmma(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int Hq, int Hkv, int Sq, int Skv, int D,
                         int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                         int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                         int64_t vss, int64_t dsb, int64_t dsh, int64_t dss,
                         int64_t dksb, int64_t dksh, int64_t dkss,
                         int64_t dvsb, int64_t dvsh, int64_t dvss,
                         float scale, int causal, int window, int q_offset,
                         float cap) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle's 1024-byte atoms need a 1024-byte aligned base
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const Ks = base;
  uint8_t* const Vs = base + SW_TILE;
  uint8_t* const Qs = base + 2 * SW_TILE;   // [2] buffers
  uint8_t* const DOs = base + 4 * SW_TILE;  // [2] buffers
  float* const lses = reinterpret_cast<float*>(base + 6 * SW_TILE);  // [2][64]
  float* const dls = lses + 2 * 64;                                  // [2][64]
  const float scale_log2 = scale * LOG2E;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int j0 = blockIdx.y * BK_M;  // the first key tiles see most rows
  const int key_lo = j0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
  // the keys in the query rows' frame (position less q_offset: live)
  const int off = q_offset;
  const int j0r = j0 - off;

  load_sw(Ks, k + b * ksb + hk * ksh, j0, Skv, D, kss);
  load_sw(Vs, v + b * vsb + hk * vsh, j0, Skv, D, vss);
  cp_async_commit();

  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;

  int q_begin, q_end;  // none: dK and dV are 0
  query_range(j0, BK_M, Sq, causal, window, off, 64, &q_begin, &q_end);
  const int nqt = q_end > q_begin ? (q_end - q_begin + 63) / 64 : 0;
  const int n_steps = G * nqt;

  auto issue = [&](int it, int buf) {
    const int h = hk * G + it / nqt;
    const int i0 = q_begin + (it % nqt) * 64;
    load_sw(Qs + buf * SW_TILE, q + b * qsb + h * qsh, i0, Sq, D, qss);
    load_sw(DOs + buf * SW_TILE, dout + b * dsb + h * dsh, i0, Sq, D, dss);
    const int t = threadIdx.x % 64;  // threads 0-63 lse, 64-127 delta
    const float* src = (threadIdx.x < 64 ? lse : delta) +
                       (static_cast<int64_t>(b) * Hq + h) * Sq;
    float* dst = (threadIdx.x < 64 ? lses : dls) + buf * 64 + t;
    const bool ok = i0 + t < Sq;
    cp_async4(dst, ok ? src + i0 + t : src, ok);
  };
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();

  for (int it = 0; it < n_steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_steps) {  // the next step loads while this one computes
      issue(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // the copies, seen by wgmma
    __syncthreads();
    const int i0 = q_begin + (it % nqt) * 64;
    const uint8_t* qt = Qs + buf * SW_TILE;
    const uint8_t* dt = DOs + buf * SW_TILE;
    const float* lt = lses + buf * 64;
    const float* dlt = dls + buf * 64;

    // S^T = K Q^T and dP^T = V dO^T: 16 d columns (32 bytes) a k step,
    // the second 64-column chunk 8 KB on
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence_regs(st);
    wgmma_fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk >> 2) * 8192 + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(st, wgmma_desc(Ks + off, 16, 1024),
                            wgmma_desc(qt + off, 16, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk >> 2) * 8192 + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(dpt, wgmma_desc(Vs + off, 16, 1024),
                            wgmma_desc(dt + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(st);
    wgmma_fence_regs(dpt);

    // accumulator layout: per 8-query block j, keys g and g + 8 of this
    // warp's 16, queries 2 (lane % 4) + {0, 1}
    const bool need_mask = j0 + BK_M > Skv || i0 + 64 > Sq ||
                           (causal && i0 < j0r + BK_M - 1) ||
                           (window > 0 && i0 + 63 - j0r >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * (lane % 4) + (e & 1);
        float x2, dcap = 1.f;  // the scaled (and capped) logit, log2
        if (CAP) {
          const float th = tanhf(st[4 * j + e] * scale / cap);
          x2 = th * cap * LOG2E;
          dcap = 1.f - th * th;
        } else {
          x2 = st[4 * j + e] * scale_log2;
        }
        bool ok = true;
        if (need_mask)
          ok = live(i0 + col, (e < 2 ? key_lo : key_hi) - off, Sq, Skv - off,
                    causal, window);
        const float p = ok ? bwd_exp2(x2 - lt[col] * LOG2E) : 0.f;
        st[4 * j + e] = p;                                        // P^T
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt[col]) * dcap;  // dS^T
      }
    }

    // dV += P^T dO and dK += dS^T Q over the 64 queries: P^T and dS^T
    // rounded to bf16 as A fragments (two adjacent n8 blocks make one
    // k16; under a cap also the remainders, frag_bf16), dO and Q MN-major
    // (16 query rows a k step, d chunks 8 KB apart)
    wgmma_fence_regs(dva);
    wgmma_fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      uint32_t ap[4], aplo[4], ad[4], adlo[4];
      frag_bf16(&st[8 * kb], ap, aplo);
      frag_bf16(&dpt[8 * kb], ad, adlo);
      const uint64_t b_do = wgmma_desc(dt + kb * 16 * 128, 8192, 1024);
      const uint64_t b_q = wgmma_desc(qt + kb * 16 * 128, 8192, 1024);
      wgmma_rs<DP, 1>(dva, ap, b_do);
      wgmma_rs<DP, 1>(dka, ad, b_q);
      if (CAP) {
        wgmma_rs<DP, 1>(dva, aplo, b_do);
        wgmma_rs<DP, 1>(dka, adlo, b_q);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(dva);
    wgmma_fence_regs(dka);
    __syncthreads();  // the next step refills the other buffer
  }
  cp_async_wait<0>();

  bf16* kob = dk + b * dksb + hk * dksh;
  bf16* vob = dv + b * dvsb + hk * dvsh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * (lane % 4);
    if (col < D) {
      const bool two = col + 1 < D;
      if (key_lo < Skv) {
        store_pair_bf16(kob + key_lo * dkss + col, dka[4 * j] * scale,
                        dka[4 * j + 1] * scale, two, true);
        store_pair_bf16(vob + key_lo * dvss + col, dva[4 * j],
                        dva[4 * j + 1], two, true);
      }
      if (key_hi < Skv) {
        store_pair_bf16(kob + key_hi * dkss + col, dka[4 * j + 2] * scale,
                        dka[4 * j + 3] * scale, two, true);
        store_pair_bf16(vob + key_hi * dvss + col, dva[4 * j + 2],
                        dva[4 * j + 3], two, true);
      }
    }
  }
}

// dK/dV on wgmma at D 256 (to which 128 < D < 256 is padded with zeros):
// two warpgroups (256 threads) per (batch * kv-head, 64-key tile).  dK
// and dV of the 64 keys are m64n256 accumulators of 128 registers a thread
// each, so each warpgroup keeps one.  Per step (group head, 64-row query
// tile) warpgroup 0 forms S^T = K Q^T and P^T, hands P^T times the cap's
// derivative to warpgroup 1 through shared memory (fp32, a named barrier)
// and accumulates dV += P^T dO; warpgroup 1 forms dP^T = V dO^T, dS^T =
// P^T (dP^T - delta) and accumulates dK += dS^T Q.  So each warpgroup
// runs one m64n64k16 product over D and one m64n256k16 product over the
// 64 queries a step.  Shared memory: K and V for the block (32 KB each),
// Q and dO double-buffered, the handed P^T (16 KB), lse and delta: 210
// KB, one block an SM.  Rows that are not 16-byte aligned (VEC false)
// load scalars into the same layout.
constexpr int KV2_THREADS = 2 * MMA_THREADS;

template <bool VEC, bool CAP>
__global__ void __launch_bounds__(KV2_THREADS, 1)
    flash_bwd_dkdv_wgmma2(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Hq, int Hkv, int Sq, int Skv, int D,
                          int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                          int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                          int64_t vss, int64_t dsb, int64_t dsh, int64_t dss,
                          int64_t dksb, int64_t dksh, int64_t dkss,
                          int64_t dvsb, int64_t dvsh, int64_t dvss,
                          float scale, int causal, int window, int q_offset,
                          float cap) {
  constexpr int TILE = sw_tile<256>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const Ks = base;
  uint8_t* const Vs = base + TILE;
  uint8_t* const Qs = base + 2 * TILE;   // [2] buffers
  uint8_t* const DOs = base + 4 * TILE;  // [2] buffers
  // P^T times the cap's derivative, element i of thread t at i * 128 + t
  float* const Ps = reinterpret_cast<float*>(base + 6 * TILE);
  float* const lses = Ps + 32 * MMA_THREADS;  // [2][64]
  float* const dls = lses + 2 * 64;           // [2][64]
  const float scale_log2 = scale * LOG2E;

  const int wg = threadIdx.x / MMA_THREADS, t = threadIdx.x % MMA_THREADS;
  const int warp = t / 32, lane = t % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int j0 = blockIdx.y * BK_M;  // the first key tiles see most rows
  const int key_lo = j0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
  // the keys in the query rows' frame (position less q_offset: live)
  const int off = q_offset;
  const int j0r = j0 - off;

  load_sw<4, KV2_THREADS, VEC>(Ks, k + b * ksb + hk * ksh, j0, Skv, D, kss);
  load_sw<4, KV2_THREADS, VEC>(Vs, v + b * vsb + hk * vsh, j0, Skv, D, vss);
  cp_async_commit();

  float acc[128];  // warpgroup 0: dV; warpgroup 1: dK / scale
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  int q_begin, q_end;  // none: dK and dV are 0
  query_range(j0, BK_M, Sq, causal, window, off, 64, &q_begin, &q_end);
  const int nqt = q_end > q_begin ? (q_end - q_begin + 63) / 64 : 0;
  const int n_steps = G * nqt;

  auto issue = [&](int it, int buf) {
    const int h = hk * G + it / nqt;
    const int i0 = q_begin + (it % nqt) * 64;
    load_sw<4, KV2_THREADS, VEC>(Qs + buf * TILE, q + b * qsb + h * qsh, i0,
                                 Sq, D, qss);
    load_sw<4, KV2_THREADS, VEC>(DOs + buf * TILE, dout + b * dsb + h * dsh,
                                 i0, Sq, D, dss);
    if (threadIdx.x < 128) {  // threads 0-63 lse, 64-127 delta
      const int r = threadIdx.x % 64;
      const float* src = (threadIdx.x < 64 ? lse : delta) +
                         (static_cast<int64_t>(b) * Hq + h) * Sq;
      float* dst = (threadIdx.x < 64 ? lses : dls) + buf * 64 + r;
      const bool ok = i0 + r < Sq;
      cp_async4(dst, ok ? src + i0 + r : src, ok);
    }
  };
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();

  for (int it = 0; it < n_steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_steps) {  // the next step loads while this one computes
      issue(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // the copies and scalar stores, seen by wgmma
    __syncthreads();
    const int i0 = q_begin + (it % nqt) * 64;
    const uint8_t* qt = Qs + buf * TILE;
    const uint8_t* dt = DOs + buf * TILE;

    // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T (16 d columns
    // a k step, 64-column chunks 8 KB apart)
    const uint8_t* ka = wg == 0 ? Ks : Vs;
    const uint8_t* kb = wg == 0 ? qt : dt;
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    wgmma_fence_regs(x);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int off = (kk >> 2) * 8192 + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(x, wgmma_desc(ka + off, 16, 1024),
                            wgmma_desc(kb + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(x);

    // accumulator layout: per 8-query block j, keys g and g + 8 of this
    // warp's 16, queries 2 (lane % 4) + {0, 1}
    if (wg == 0) {
      const float* lt = lses + buf * 64;
      const bool need_mask = j0 + BK_M > Skv || i0 + 64 > Sq ||
                             (causal && i0 < j0r + BK_M - 1) ||
                             (window > 0 && i0 + 63 - j0r >= window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * (lane % 4) + (e & 1);
          float x2, dcap = 1.f;  // the scaled (and capped) logit, log2
          if (CAP) {
            const float th = tanhf(x[4 * j + e] * scale / cap);
            x2 = th * cap * LOG2E;
            dcap = 1.f - th * th;
          } else {
            x2 = x[4 * j + e] * scale_log2;
          }
          bool ok = true;
          if (need_mask)
            ok = live(i0 + col, (e < 2 ? key_lo : key_hi) - off, Sq,
                      Skv - off, causal, window);
          const float p = ok ? bwd_exp2(x2 - lt[col] * LOG2E) : 0.f;
          Ps[(4 * j + e) * MMA_THREADS + t] = p * dcap;
          x[4 * j + e] = p;  // P^T
        }
      }
      named_bar_arrive(1, KV2_THREADS);
    } else {
      const float* dlt = dls + buf * 64;
      named_bar_sync(1, KV2_THREADS);  // warpgroup 0's P^T is in
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * (lane % 4) + (e & 1);
          x[4 * j + e] = Ps[(4 * j + e) * MMA_THREADS + t] *
                         (x[4 * j + e] - dlt[col]);  // dS^T / scale
        }
      }
    }

    // warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q, over the 64
    // queries: P^T or dS^T rounded to bf16 as A fragments (two adjacent n8
    // blocks make one k16; under a cap also the remainder, frag_bf16), dO
    // or Q MN-major (16 query rows a k step)
    const uint8_t* mn = wg == 0 ? dt : qt;
    wgmma_fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kb2 = 0; kb2 < 4; ++kb2) {
      uint32_t a[4], alo[4];
      frag_bf16(&x[8 * kb2], a, alo);
      const uint64_t b_mn = wgmma_desc(mn + kb2 * 16 * 128, 8192, 1024);
      wgmma_rs<256, 1>(acc, a, b_mn);
      if (CAP) wgmma_rs<256, 1>(acc, alo, b_mn);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    __syncthreads();  // the next step refills the other buffer and P^T
  }
  cp_async_wait<0>();

  const float mul = wg == 0 ? 1.f : scale;
  bf16* ob = wg == 0 ? dv + b * dvsb + hk * dvsh : dk + b * dksb + hk * dksh;
  const int64_t oss = wg == 0 ? dvss : dkss;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = j * 8 + 2 * (lane % 4);
    if (col < D) {
      const bool two = col + 1 < D;
      if (key_lo < Skv)
        store_pair_bf16(ob + key_lo * oss + col, acc[4 * j] * mul,
                        acc[4 * j + 1] * mul, two, VEC);
      if (key_hi < Skv)
        store_pair_bf16(ob + key_hi * oss + col, acc[4 * j + 2] * mul,
                        acc[4 * j + 3] * mul, two, VEC);
    }
  }
}

// dQ on wgmma at D 80, 128 (16-byte aligned rows) and 256 (DP): one
// warpgroup per (batch * q-head, 64-row query tile), heaviest causal tiles
// first.  Per 64-key tile it recomputes S = Q K^T and dP = dO V^T
// (m64n64k16, operands K-major from shared memory) and P; a first sweep
// over the tiles sums delta = rowsum(P dP) in fp32 and writes it for the
// dK/dV kernel, the second forms dS and dQ += dS K (m64n{DP}k16, dS from
// registers, K MN-major).  Q and dO stay for the block; K and V tiles are
// double-buffered.  At DP 256 the tiles take 192 KB (one block an SM) and
// dQ 128 registers a thread; rows that are not 16-byte aligned (VEC false)
// load scalars into the same layout.
template <int DP, bool VEC, bool CAP, bool DIN>
__global__ void __launch_bounds__(MMA_THREADS, DP > 128 ? 1 : 2)
    flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       int Hq, int Hkv, int Sq, int Skv, int D, int64_t qsb,
                       int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                       int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
                       int64_t dsb, int64_t dsh, int64_t dss, int64_t dqsb,
                       int64_t dqsh, int64_t dqss, float scale, int causal,
                       int window, int q_offset, float cap) {
  constexpr int TILE = sw_tile<DP>(), NCH = TILE / 8192;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const Qs = base;
  uint8_t* const DOs = base + TILE;
  uint8_t* const Ks = base + 2 * TILE;  // [2] buffers
  uint8_t* const Vs = base + 4 * TILE;  // [2] buffers
  const float scale_log2 = scale * LOG2E;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const int off = DIN ? q_offset : 0;  // with delta_in only
  const int p0 = q0 + off;  // the tile's first position

  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;
  const bf16* db = dout + b * dsb + h * dsh;
  load_sw<NCH, MMA_THREADS, VEC>(Qs, q + b * qsb + h * qsh, q0, Sq, D, qss);
  load_sw<NCH, MMA_THREADS, VEC>(DOs, db, q0, Sq, D, dss);
  cp_async_commit();

  // the forward's key tiles (none: the rows' dQ is 0)
  int k_begin, k_end;
  key_range(p0, min(64, Sq - q0), Skv, causal, window, 64, &k_begin, &k_end);
  if (k_begin < k_end) {
    load_sw<NCH, MMA_THREADS, VEC>(Ks, kb, k_begin, Skv, D, kss);
    load_sw<NCH, MMA_THREADS, VEC>(Vs, vb, k_begin, Skv, D, vss);
  }
  cp_async_commit();

  // per row: lse in log2 units, and delta = rowsum(P dP), summed in fp32
  // over the first sweep
  const int64_t bhq = static_cast<int64_t>(b) * Hq + h;
  const float* lb = lse + bhq * Sq;
  const float l2[2] = {row_lo < Sq ? lb[row_lo] * LOG2E : 0.f,
                       row_hi < Sq ? lb[row_hi] * LOG2E : 0.f};
  float dl[2] = {0.f, 0.f};

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  // sweep 0 forms delta, sweep 1 dQ; each recomputes S, dP and P per tile.
  // With DIN the caller's delta is read and sweep 0 does not run: the
  // first tile's load is already in flight, as at sweep 0's start
  if (DIN) {
    if (row_lo < Sq) dl[0] = delta[bhq * Sq + row_lo];
    if (row_hi < Sq) dl[1] = delta[bhq * Sq + row_hi];
  }
  for (int sweep = DIN ? 1 : 0; sweep < 2; ++sweep) {
    if (sweep == 1 && !DIN) {
      dl[0] = quad_sum(dl[0]);
      dl[1] = quad_sum(dl[1]);
      if (lane % 4 == 0) {  // for the dK/dV kernel
        if (row_lo < Sq) delta[bhq * Sq + row_lo] = dl[0];
        if (row_hi < Sq) delta[bhq * Sq + row_hi] = dl[1];
      }
      if (k_begin < k_end) {  // the first tile again (all reads are done)
        load_sw<NCH, MMA_THREADS, VEC>(Ks, kb, k_begin, Skv, D, kss);
        load_sw<NCH, MMA_THREADS, VEC>(Vs, vb, k_begin, Skv, D, vss);
      }
      cp_async_commit();
    }
    int buf = 0;
    for (int j0 = k_begin; j0 < k_end; j0 += 64, buf ^= 1) {
      if (j0 + 64 < k_end) {  // the next tile loads while this one computes
        load_sw<NCH, MMA_THREADS, VEC>(Ks + (buf ^ 1) * TILE, kb, j0 + 64,
                                       Skv, D, kss);
        load_sw<NCH, MMA_THREADS, VEC>(Vs + (buf ^ 1) * TILE, vb, j0 + 64,
                                       Skv, D, vss);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();
      __syncthreads();
      const uint8_t* kt = Ks + buf * TILE;
      const uint8_t* vt = Vs + buf * TILE;

      // S = Q K^T and dP = dO V^T
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence_regs(s);
      wgmma_fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk >> 2) * 8192 + (kk & 3) * 32;
        wgmma_m64n64k16<0, 0>(s, wgmma_desc(Qs + off, 16, 1024),
                              wgmma_desc(kt + off, 16, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk >> 2) * 8192 + (kk & 3) * 32;
        wgmma_m64n64k16<0, 0>(dp, wgmma_desc(DOs + off, 16, 1024),
                              wgmma_desc(vt + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      wgmma_fence_regs(dp);

      const bool need_mask = j0 + 64 > Skv || q0 + 64 > Sq ||
                             (causal && j0 + 63 > p0) ||
                             (window > 0 && p0 + 63 - j0 >= window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x2, dcap = 1.f;  // the scaled (and capped) logit, log2 units
          if (CAP) {
            const float th = tanhf(s[4 * j + e] * scale / cap);
            x2 = th * cap * LOG2E;
            dcap = 1.f - th * th;
          } else {
            x2 = s[4 * j + e] * scale_log2;
          }
          bool ok = true;
          if (need_mask)
            ok = live(e < 2 ? row_lo : row_hi,
                      j0 - off + j * 8 + 2 * (lane % 4) + (e & 1), Sq,
                      Skv - off, causal, window);
          const float p = ok ? bwd_exp2(x2 - l2[e / 2]) : 0.f;
          if (sweep == 0) dl[e / 2] += p * dp[4 * j + e];
          s[4 * j + e] = p * (dp[4 * j + e] - dl[e / 2]) * dcap;  // dS/scale
        }
      }
      if (sweep == 0) {
        __syncthreads();  // the next iteration refills the other buffer
        continue;
      }

      // dQ += dS K: dS rounded to bf16 as A fragments (under a cap also
      // the remainder, frag_bf16), K MN-major
      wgmma_fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kb2 = 0; kb2 < 4; ++kb2) {
        uint32_t a[4], alo[4];
        frag_bf16(&s[8 * kb2], a, alo);
        const uint64_t b_k = wgmma_desc(kt + kb2 * 16 * 128, 8192, 1024);
        wgmma_rs<DP, 1>(acc, a, b_k);
        if (CAP) wgmma_rs<DP, 1>(acc, alo, b_k);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      __syncthreads();  // the next iteration refills the other buffer
    }
    cp_async_wait<0>();
  }

  bf16* ob = dq + b * dqsb + h * dqsh;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * (lane % 4);
    if (col < D) {
      const bool two = col + 1 < D;
      if (row_lo < Sq)
        store_pair_bf16(ob + row_lo * dqss + col, acc[4 * j] * scale,
                        acc[4 * j + 1] * scale, two, VEC);
      if (row_hi < Sq)
        store_pair_bf16(ob + row_hi * dqss + col, acc[4 * j + 2] * scale,
                        acc[4 * j + 3] * scale, two, VEC);
    }
  }
}

// dQ (which writes delta, or reads it: its DIN) and then dK/dV, each on
// its kernel, the dK/dV kernel with kv_threads threads a block
template <typename QKern, typename KVKern>
int launch_bwd_pair(QKern q_kern, KVKern kv_kern, size_t smem_q,
                    size_t smem_kv, int kv_threads, const bf16* Q,
                    const bf16* K,
                    const bf16* V, const bf16* DO,
                    const float* lse, float* delta, void* dq, void* dk,
                    void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                    const int64_t* st, float scale, int causal, int window,
                    int q_offset, float cap, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(q_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(B) * Hq,
            static_cast<unsigned>((Sq + BQ_M - 1) / BQ_M));
  q_kern<<<grid, MMA_THREADS, smem_q, s>>>(
      Q, K, V, DO, lse, delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12],
      st[13], st[14], st[15], st[16], st[17], scale, causal, window,
      q_offset, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || Skv == 0) return static_cast<int>(err);
  dim3 kv_grid(static_cast<unsigned>(B) * Hkv,
               static_cast<unsigned>((Skv + BK_M - 1) / BK_M));
  kv_kern<<<kv_grid, kv_threads, smem_kv, s>>>(
      Q, K, V, DO, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Hq, Hkv, Sq, Skv, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14],
      st[18], st[19], st[20], st[21], st[22], st[23], scale, causal, window,
      q_offset, cap);
  return static_cast<int>(cudaGetLastError());
}

// wgmma at D 256 (any row alignment) and at D 80 and 128 with 16-byte
// aligned rows, else mma.sync
template <int DP, bool VEC, bool CAP, bool DIN>
int launch_bwd_mma_c(const bf16* Q, const bf16* K, const bf16* V,
                     const bf16* DO, const float* lse, float* delta,
                     void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                     int Sq, int Skv, int D, const int64_t* st, float scale,
                     int causal, int window, int q_offset, float cap,
                     cudaStream_t s) {
  constexpr size_t lse_bytes = 4 * 64 * sizeof(float);
  if constexpr (DP == 256) {
    constexpr int tiles = 6 * sw_tile<256>();
    return launch_bwd_pair(
        flash_bwd_dq_wgmma<256, VEC, CAP, DIN>,
        flash_bwd_dkdv_wgmma2<VEC, CAP>,
        tiles + 1024,
        tiles + 32 * MMA_THREADS * sizeof(float) + lse_bytes + 1024,
        KV2_THREADS, Q, K, V, DO, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq,
        Skv, D, st, scale, causal, window, q_offset, cap, s);
  } else if constexpr ((DP == 80 || DP == 128) && VEC) {
    return launch_bwd_pair(
        flash_bwd_dq_wgmma<DP, true, CAP, DIN>,
        flash_bwd_dkdv_wgmma<DP, CAP>, 6 * SW_TILE + 1024,
        6 * SW_TILE + lse_bytes + 1024, MMA_THREADS, Q, K, V, DO, lse, delta,
        dq, dk, dv, B, Hq, Hkv, Sq, Skv, D, st, scale, causal, window,
        q_offset, cap, s);
  } else {
    constexpr int QT = kv_rows<DP>();
    return launch_bwd_pair(
        flash_bwd_dq_mma<DP, VEC, BK_Q, CAP, DIN>,
        flash_bwd_dkdv_mma<DP, VEC, QT, CAP, DIN || kv_blocks<DP>() == 1>,
        dq_smem<DP, BK_Q>(),
        dkdv_smem<DP, QT>(), MMA_THREADS, Q, K, V, DO, lse, delta, dq, dk,
        dv, B, Hq, Hkv, Sq, Skv, D, st, scale, causal, window, q_offset, cap,
        s);
  }
}

template <int DP, bool VEC>
int launch_bwd_mma(const bf16* Q, const bf16* K, const bf16* V,
                   const bf16* DO, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                   int Hkv, int Sq, int Skv, int D, const int64_t* st,
                   float scale, int causal, int window, int q_offset,
                   float cap, int delta_in, cudaStream_t s) {
  // the cap and delta_in as template arguments: each case is its own
  // kernel, so the own-delta kernels carry nothing of delta_in.  The query
  // offset comes only with delta_in (the launcher refuses it without): the
  // delta_in dQ kernels read it, so the own-delta ones, which every call
  // through autograd takes, compile to the offset-free code, as the
  // mma.sync dK/dV kernels at three blocks an SM do (their OFF)
  auto run = cap > 0.f
                 ? (delta_in ? launch_bwd_mma_c<DP, VEC, true, true>
                             : launch_bwd_mma_c<DP, VEC, true, false>)
                 : (delta_in ? launch_bwd_mma_c<DP, VEC, false, true>
                             : launch_bwd_mma_c<DP, VEC, false, false>);
  return run(Q, K, V, DO, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Skv, D, st,
             scale, causal, window, q_offset, cap, s);
}

template <int DP>
int launch_bwd_mma_v(const bf16* Q, const bf16* K, const bf16* V,
                     const bf16* DO, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B,
                     int Hq, int Hkv, int Sq, int Skv, int D,
                     const int64_t* st, float scale, int causal, int window,
                     int q_offset, float cap, int delta_in, bool vec,
                     cudaStream_t s) {
  if (vec)
    return launch_bwd_mma<DP, true>(Q, K, V, DO, lse, delta, dq, dk, dv,
                                    B, Hq, Hkv, Sq, Skv, D, st, scale,
                                    causal, window, q_offset, cap, delta_in,
                                    s);
  return launch_bwd_mma<DP, false>(Q, K, V, DO, lse, delta, dq, dk, dv, B,
                                   Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                   window, q_offset, cap, delta_in, s);
}

int launch_bwd_mma_d(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B,
                     int Hq, int Hkv, int Sq, int Skv, int D,
                     const int64_t* st, float scale, int causal, int window,
                     int q_offset, float cap, int delta_in, cudaStream_t s) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* DO = static_cast<const bf16*>(dout);
  // 16-byte cp.async loads and paired stores need every row 16-byte
  // aligned; otherwise the same kernels load scalars into the same layout
  // (o, st[9..11], is not read)
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  bool vec = D % 8 == 0;
  for (int i = 0; i < 7; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 24; ++i)
    vec = vec && (i / 3 == 3 || st[i] % 8 == 0);
  if (D <= 64)
    return launch_bwd_mma_v<64>(Q, K, V, DO, lse, delta, dq, dk, dv, B,
                                Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                window, q_offset, cap, delta_in, vec, s);
  if (D <= 80)
    return launch_bwd_mma_v<80>(Q, K, V, DO, lse, delta, dq, dk, dv, B,
                                Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                window, q_offset, cap, delta_in, vec, s);
  if (D <= 96)
    return launch_bwd_mma_v<96>(Q, K, V, DO, lse, delta, dq, dk, dv, B,
                                Hq, Hkv, Sq, Skv, D, st, scale, causal,
                                window, q_offset, cap, delta_in, vec, s);
  if (D <= 128)
    return launch_bwd_mma_v<128>(Q, K, V, DO, lse, delta, dq, dk, dv, B, Hq,
                                 Hkv, Sq, Skv, D, st, scale, causal, window,
                                 q_offset, cap, delta_in, vec, s);
  return launch_bwd_mma_v<256>(Q, K, V, DO, lse, delta, dq, dk, dv, B, Hq,
                               Hkv, Sq, Skv, D, st, scale, causal, window,
                               q_offset, cap, delta_in, vec, s);
}
}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}// The backward of flash_attention_launch: dq, dk, dv (q's, k's and v's
// dtype, any (batch, head, seq) strides, unit stride on D) from q, k, v,
// the forward's o and lse, and dout (o's shape).  delta: a contiguous fp32
// [B, Hq, Sq]; with delta_in 0 a scratch the kernels fill with rowsum(dO
// O), with delta_in 1 the caller's delta, read and not formed (ring
// attention's rounds need one delta over all of a row's keys, which no
// round's launch sees).  q_offset as the forward's (query row r at position
// r + q_offset against key c at c in the causal and window masks; a row
// that sees no key gets dQ 0, a key that no row sees dK and dV 0), nonzero
// only with delta_in: a ring round's launch.  The 24 strides are those of
// q, k, v, o, dout, dq, dk and dv, three each.  path: kPathSimt (the
// CUDA-core kernels) for fp32, or kPathMma (tensor cores) for bf16; others
// and a refused offset return cudaErrorInvalidValue.  The bf16 kernels
// form delta from P and dP and do not read o.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int64_t dsb, int64_t dsh, int64_t dss, int64_t dqsb,
    int64_t dqsh, int64_t dqss, int64_t dksb, int64_t dksh, int64_t dkss,
    int64_t dvsb, int64_t dvsh, int64_t dvss, float scale, int causal,
    int window, int q_offset, float cap, int delta_in, int dtype, int path,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv < 0 || D <= 0 || D > 256 || (Sq + BBQ - 1) / BBQ > 65535 ||
      (Skv + BBK - 1) / BBK > 65535 || q_offset < 0 ||
      q_offset > INT32_MAX - 64 - Sq || (q_offset != 0 && !delta_in))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[24] = {qsb,  qsh,  qss,  ksb,  ksh,  kss,  vsb,  vsh,
                          vss,  osb,  osh,  oss,  dsb,  dsh,  dss,  dqsb,
                          dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kPathMma && dtype == kBF16)
    return launch_bwd_mma_d(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,
                            Sq, Skv, D, st, scale, causal, window, q_offset,
                            cap, delta_in, s);
  if (path == kPathSimt && dtype == kF32)
    return launch_bwd_simt_d(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq,
                             Hkv, Sq, Skv, D, st, scale, causal, window,
                             q_offset, cap, delta_in, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
