// Mamba-2 SSD intra-chunk pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py
// (_ssd_kernel, launched by ssd_intra_chunk).  For every chunk c and head
// h, with cum = cumsum(dt * a[h]) along the chunk's Q positions:
//
//   y[c,q,h,p]  = sum_{s<=q} (C[c,q,:] . B[c,s,:]) exp(cum_q - cum_s)
//                            dt[c,s,h] x[c,s,h,p]
//   st[c,h,p,n] = sum_s exp(cum_{Q-1} - cum_s) dt[c,s,h] x[c,s,h,p] B[c,s,n]
//   g[c,h]      = exp(cum_{Q-1})
//
// all in fp32.  The inter-chunk recurrence that stitches the chunks
// together stays in torch (kernels/ssd/ops.py), as the reference keeps it
// outside its Pallas call.
//
// What bounds it on this card: at mamba2-780m's prefill shape (8 chunks of
// Q = 256, H = 48, P = 64, N = 128) one launch needs ~3.3 GFLOP counting
// only the causal (s <= q) pairs and C.B^T once per chunk, and moves
// ~65 MB (x in, y out, states out, B/C/dt in): ~50 operations per byte,
// above the fp32 CUDA-core balance point (67 TFLOP/s over 3.35 TB/s = 20),
// so its floor is arithmetic (~49 us at 67 TFLOP/s).  This first version
// recomputes C.B^T for every head (48x the C.B^T work at mamba2's shape)
// and feeds its FMAs from shared memory, so in practice it is bound by
// shared-memory bandwidth and FMA issue; sharing C.B^T across a head block
// and tensor cores (TF32 or split-bf16 wgmma) are the first things a later
// version changes.
//
// Design:
//   * One 256-thread block per (chunk, head).  The TPU kernel holds a
//     [Q, Q, heads] decay tensor in VMEM (~6 MB at Q = 256 with 8 heads);
//     here nothing quadratic leaves registers and shared memory: the block
//     walks 64-row q tiles and, inside each, the 64-column s tiles up to
//     the diagonal.  For each pair it forms the C.B^T tile over N (4 x 4
//     outputs a thread), scales it by the masked decay and dt_s into a
//     shared 64 x 64 tile M, and accumulates y += M @ x_tile in registers;
//     the y tile is written once.
//   * cum is a sequential fp32 sum over the chunk in one thread (the order
//     of torch.cumsum on the CPU; Q adds, negligible beside the products).
//   * The decay is selected with the causal mask, never multiplied by it:
//     exp(cum_q - cum_s) overflows to inf above the diagonal (cum falls to
//     ~-400 over a chunk at a = -16, dt = 0.1), and inf * 0 is NaN.  The
//     quotient exp(cum_q) / exp(cum_s) is never formed (0 / 0 there).
//   * A second pass builds the state, st = (x * w)^T @ B with
//     w_s = exp(cum_{Q-1} - cum_s) dt_s, in 64 x 64 output tiles.
//   * Inputs are read through their strides (unit stride on the last dim),
//     so the model's column slices of the conv output need no copy.
//     Ragged Q, P and N edges are masked in the kernel.  Shared memory:
//     ~101 KB at N = 128, P = 64 (dynamic, above the 48 KB default).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TILE = 64;      // q, s, p and n tile edge
constexpr int MAX_P = 64;
constexpr int MAX_N = 256;

struct Layout {
  int ldc, ldb, ldx;  // padded row pitches of the C, B and x tiles
  size_t floats;      // total shared floats
};

__host__ __device__ inline Layout layout(int Q, int P, int N) {
  Layout L;
  L.ldc = N + 1;
  L.ldb = (N > TILE ? N : TILE) + 1;
  L.ldx = P + 1;
  L.floats = 3 * static_cast<size_t>(Q) +
             static_cast<size_t>(TILE) * (L.ldc + L.ldb + L.ldx + TILE + 1);
  return L;
}

// PJ: p columns a thread owns in the y pass (and p rows in the state
// pass), 16 apart; P <= 16 * PJ.
template <int PJ>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_fwd(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const float* __restrict__ bm,
                  const float* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ st, float* __restrict__ g, int H,
                  int Q, int P, int N, int64_t xsb, int64_t xsq,
                  int64_t xsh, int64_t dsb, int64_t dsq, int64_t bsb,
                  int64_t bsq, int64_t csb, int64_t csq) {
  extern __shared__ float smem[];
  const Layout L = layout(Q, P, N);
  float* cum = smem;                 // [Q]
  float* dts = cum + Q;              // [Q]
  float* ws = dts + Q;               // [Q] state weights
  float* Cs = ws + Q;                // [TILE][ldc]
  float* Bs = Cs + TILE * L.ldc;     // [TILE][ldb]
  float* Xs = Bs + TILE * L.ldb;     // [TILE][ldx]
  float* Ms = Xs + TILE * L.ldx;     // [TILE][TILE + 1]
  constexpr int LDM = TILE + 1;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x / H, h = blockIdx.x % H;

  const float* xb = x + c * xsb + h * xsh;
  const float* db = dt + c * dsb + h;
  const float* bb = bm + c * bsb;
  const float* cb = cm + c * csb;

  for (int s = tid; s < Q; s += THREADS) dts[s] = db[s * dsq];
  __syncthreads();
  if (tid == 0) {
    const float ah = a[h];
    float run = 0.f;
    for (int s = 0; s < Q; ++s) {
      run = run + __fmul_rn(dts[s], ah);  // round dt*a first, as torch does
      cum[s] = run;
    }
    g[static_cast<int64_t>(c) * H + h] = expf(run);
  }
  __syncthreads();
  // decay from s to the chunk's end, times dt_s (the state's weights)
  for (int s = tid; s < Q; s += THREADS)
    ws[s] = expf(cum[Q - 1] - cum[s]) * dts[s];

  // ---- pass 1: y ---------------------------------------------------------
  float* yb = y + (static_cast<int64_t>(c) * Q * H + h) * P;
  for (int q0 = 0; q0 < Q; q0 += TILE) {
    __syncthreads();  // previous tile's reads of Cs done
    for (int e = tid; e < TILE * N; e += THREADS) {
      const int r = e / N, n = e % N;
      Cs[r * L.ldc + n] = (q0 + r < Q) ? cb[(q0 + r) * csq + n] : 0.f;
    }
    float acc[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

    for (int s0 = 0; s0 <= q0; s0 += TILE) {
      __syncthreads();  // previous pair's reads of Bs, Xs, Ms done
      for (int e = tid; e < TILE * N; e += THREADS) {
        const int r = e / N, n = e % N;
        Bs[r * L.ldb + n] = (s0 + r < Q) ? bb[(s0 + r) * bsq + n] : 0.f;
      }
      for (int e = tid; e < TILE * P; e += THREADS) {
        const int r = e / P, p = e % P;
        Xs[r * L.ldx + p] = (s0 + r < Q) ? xb[(s0 + r) * xsq + p] : 0.f;
      }
      __syncthreads();

      float cbt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cbt[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * L.ldc + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * L.ldb + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cbt[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx + 16 * j;
          // select, never multiply by the mask (inf above the diagonal)
          float m = 0.f;
          if (s <= q && q < Q)
            m = cbt[i][j] * expf(cum[q] - cum[s]) * dts[s];
          Ms[(ty + 16 * i) * LDM + tx + 16 * j] = m;
        }
      }
      __syncthreads();

      const int s_end = min(TILE, Q - s0);
      for (int s = 0; s < s_end; ++s) {
        float mv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = Ms[(ty + 16 * i) * LDM + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < P ? Xs[s * L.ldx + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += mv[i] * xv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q >= Q) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int p = tx + 16 * j;
        if (p < P) yb[static_cast<int64_t>(q) * H * P + p] = acc[i][j];
      }
    }
  }

  // ---- pass 2: the chunk's outgoing state ---------------------------------
  float* sb = st + (static_cast<int64_t>(c) * H + h) * P * N;
  for (int n0 = 0; n0 < N; n0 += TILE) {
    float acc[PJ][4];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += TILE) {
      __syncthreads();  // previous reads of Bs, Xs done
      for (int e = tid; e < TILE * P; e += THREADS) {
        const int r = e / P, p = e % P;
        const int s = s0 + r;
        Xs[r * L.ldx + p] = s < Q ? xb[s * xsq + p] * ws[s] : 0.f;
      }
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int r = e / TILE, nl = e % TILE;
        const bool in = s0 + r < Q && n0 + nl < N;
        Bs[r * L.ldb + nl] = in ? bb[(s0 + r) * bsq + n0 + nl] : 0.f;
      }
      __syncthreads();
      const int s_end = min(TILE, Q - s0);
      for (int s = 0; s < s_end; ++s) {
        float xv[PJ], bv[4];
#pragma unroll
        for (int i = 0; i < PJ; ++i) {
          const int p = ty + 16 * i;
          xv[i] = p < P ? Xs[s * L.ldx + p] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[s * L.ldb + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * bv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < PJ; ++i) {
      const int p = ty + 16 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < N) sb[static_cast<int64_t>(p) * N + n] = acc[i][j];
      }
    }
  }
}

template <int PJ>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, float* y, float* st, float* g, int BC, int H,
           int Q, int P, int N, const int64_t* sd, cudaStream_t s) {
  const size_t smem = layout(Q, P, N).floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_fwd<PJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(BC) * static_cast<unsigned>(H);
  ssd_chunk_fwd<PJ><<<grid, THREADS, smem, s>>>(
      x, dt, a, bm, cm, y, st, g, H, Q, P, N, sd[0], sd[1], sd[2], sd[3],
      sd[4], sd[5], sd[6], sd[7], sd[8]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [BC, Q, H, P] by its (chunk, q, head) element strides, unit stride on
// P; dt: [BC, Q, H] by its (chunk, q) strides, unit stride on H; a: [H]
// contiguous; B and C: [BC, Q, N] by their (chunk, q) strides, unit stride
// on N.  Writes contiguous y [BC, Q, H, P], st [BC, H, P, N], g [BC, H].
// Returns cudaGetLastError() after the launch (0 = launched).
int ssd_intra_chunk_launch(const float* x, const float* dt, const float* a,
                           const float* bm, const float* cm, float* y,
                           float* st, float* g, int BC, int Q, int H, int P,
                           int N, int64_t xsb, int64_t xsq, int64_t xsh,
                           int64_t dsb, int64_t dsq, int64_t bsb,
                           int64_t bsq, int64_t csb, int64_t csq,
                           void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 ||
      N > MAX_N || static_cast<int64_t>(BC) * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t sd[9] = {xsb, xsq, xsh, dsb, dsq, bsb, bsq, csb, csq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 16)
    return launch<1>(x, dt, a, bm, cm, y, st, g, BC, H, Q, P, N, sd, s);
  if (P <= 32)
    return launch<2>(x, dt, a, bm, cm, y, st, g, BC, H, Q, P, N, sd, s);
  return launch<4>(x, dt, a, bm, cm, y, st, g, BC, H, Q, P, N, sd, s);
}

}  // extern "C"
