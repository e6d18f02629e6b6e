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
// all in fp32 in and out.  The inter-chunk recurrence that stitches the
// chunks together stays in torch (kernels/ssd/ops.py), as the reference
// keeps it outside its Pallas call.
//
// What bounds it on this card: at mamba2-780m's prefill shape (8 chunks of
// Q = 256, H = 48, P = 64, N = 128) one launch needs ~3.3 GFLOP counting
// only the causal (s <= q) pairs and C.B^T once per chunk, and moves
// ~65 MB (x in, y out, states out, B/C/dt in).  Its products run on the
// tensor cores at fp32 accuracy, whose fastest rate is 495 TF32 TFLOP/s
// over three products (165 TFLOP/s): ~20 us of operations beside ~20 us
// of bytes (zamba2-2.7b: 25 us beside 29 us).  In practice the kernel is
// bound by latency: at two to three 4-warp blocks an SM (registers and
// shared memory allow no more) the warps cannot hide the chains of
// fragment load, operand split, decay exp and mma.sync, and each step (one
// s tile of one head) ends at a barrier.  Neither the tensor pipe nor
// instruction issue is near full; occupancy is what moves it.
//
// Design:
//   * B and C are shared by every head of a chunk (one group), so C.B^T is
//     too.  A y block owns (chunk, head block of HB heads, 64-row q tile):
//     for each TS-row s tile up to the diagonal it computes the 64 x TS
//     C.B^T tile once and applies it to all HB heads,
//     M_h = select(s <= q, CB exp(cum_q - cum_s) dt_s, 0), y_h += M_h x_h.
//     Warp w owns q rows 16 w .. 16 w + 15; the C.B^T tile and the y tiles
//     of the HB heads stay in registers.  HB = 2 and TS = 32 at N = 128,
//     HB = 2 and TS = 64 at N <= 64 (three blocks an SM); HB = 4 and
//     TS = 64 at N = 256 (one); HB = 1 only where cum of HB heads would
//     not fit (chunks of thousands of rows).
//   * A state block owns (chunk, head): st^T = B^T (x * w) over all s
//     tiles, w_s = exp(cum_{Q-1} - cum_s) dt_s; warp w owns a quarter of
//     the n rows and all 64 p, so each warp splits only its quarter of a
//     B tile.
//   * Causal balance: blocks are numbered heaviest first (y of the last q
//     tiles, then the states, then y of q tile 0), so the block scheduler
//     fills the SMs evenly whatever the shape.
//   * Products on mma.sync m16n8k8 tf32 with the 3xTF32 split:
//     a = a_hi + a_lo, a_hi = a truncated to tf32, a_lo = (a - a_hi)
//     truncated, and a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi: ~21 bits of
//     mantissa, fp32 sums (y within ~4e-5 of the fp32 reference at the
//     main shapes).  Single-pass TF32 (10 bits) misses rtol = atol = 1e-3
//     on y.
//   * Registers, not shared memory, carry M into M @ x: the k order inside
//     an m16n8k8 product is free, so the accumulator's (row, 2t) and
//     (row, 2t + 1) are fed as k = t and t + 4 of the A fragment, and the
//     B fragment (x, or B in the state) reads rows 2t and 2t + 1 to match.
//     Row pitches of 4 (mod 32) floats make every fragment read
//     conflict-free.
//   * Loads overlap math, by cp.async: a y block keeps its C tile, loads
//     the next B tile once C.B^T is done with the current one, and each
//     step's x tile during the step before; a state block double-buffers
//     (B, x).  ~72 KB of shared memory at N = 128, ~74 KB at N = 64.
//     Rows whose address or pitch is not 16-byte aligned load scalars into
//     the same layout in the same kernel; ragged Q, P, N and H are
//     zero-filled or masked.
//   * cum is a sequential fp32 sum over the chunk in one thread per head
//     (the order of torch.cumsum on the CPU; Q adds, negligible).
//   * The decay is selected with the causal mask, never multiplied by it:
//     exp(cum_q - cum_s) overflows to inf above the diagonal (cum falls to
//     ~-400 over a chunk at a = -16, dt = 0.1), and inf * 0 is NaN.  The
//     quotient exp(cum_q) / exp(cum_s) is never formed (0 / 0 there).
//   * Inputs are read through their strides (unit stride on the last dim),
//     so the model's column slices of the conv output need no copy.

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int TILE = 64;      // q tile rows and x tile columns (P <= 64)
constexpr int LDX = TILE + 4;  // x tile pitch (floats)
constexpr int MAX_P = 64;
constexpr int MAX_N = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use
// Per N padded to NP: the s tile's rows TS and the heads HB sharing one
// C.B^T tile.  At N = 128, 32-row s tiles and two heads keep a block at
// ~72 KB of shared memory and <= 168 registers, three blocks an SM; at
// N <= 64, 64-row s tiles do the same; N = 256 runs one block an SM.
template <int NP>
__host__ __device__ constexpr int ts_rows() {
  return NP == 128 ? 32 : 64;
}

template <int NP>
__host__ __device__ constexpr int hb_max() {
  return NP <= 128 ? 2 : 4;
}

// a [TILE][NP + 4] C tile, a [TS][NP + 4] B tile, two [TS][LDX] x tiles,
// and cum and dt of hb heads
template <int NP>
size_t smem_bytes(int hb, int Q) {
  constexpr int TS = ts_rows<NP>();
  return sizeof(float) *
         (static_cast<size_t>(TILE + TS) * (NP + 4) +
          2 * static_cast<size_t>(TS) * LDX + 2 * static_cast<size_t>(hb) * Q);
}

// rows [r0, r0 + ROWS) of a [rows, cols] fp32 matrix (row pitch ld) into a
// [ROWS][LD] smem tile of W columns, zero past `rows` and `cols`; 16-byte
// cp.async where vec (base, pitch and cols multiples of 4 floats), else
// scalar loads into the same layout.
template <int ROWS, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int cols,
                                          int64_t ld, bool vec) {
  constexpr int CH = W / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, k = (e % CH) * 4;
    float* d = dst + r * LD + k;
    const bool in = r0 + r < rows;
    const float* s = src + static_cast<int64_t>(r0 + r) * ld + k;
    if (vec) {
      const bool ok = in && k < cols;
      cp_async16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = (in && k + i < cols) ? s[i] : 0.f;
    }
  }
}

// v0, v1 to p[0], p[1] where n (the columns left) allows; paired when even
// (p 8-byte aligned).
__device__ __forceinline__ void store2(float* p, float v0, float v1, int n,
                                       bool even) {
  if (n >= 2 && even) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (n >= 1) p[0] = v0;
    if (n >= 2) p[1] = v1;
  }
}

struct Args {
  const float *x, *dt, *a, *bm, *cm;
  float *y, *st, *g;
  int BC, H, Q, P, N;
  int64_t xsb, xsq, xsh, dsb, dsq, bsb, bsq, csb, csq;
  bool vx, vb, vc;  // x / B / C rows 16-byte aligned (cp.async)
};

// NP: N padded to a multiple of 64 (B and C tile width); HB: heads a
// block.
template <int NP, int HB>
__global__ void __launch_bounds__(THREADS, HB == 2 ? 3 : 1)
    ssd_chunk_fwd(const Args A) {
  constexpr int LDB = NP + 4;  // B and C tile pitch
  constexpr int TS = ts_rows<NP>();
  constexpr int KS = TS / 8;   // k8 blocks of an s tile
  extern __shared__ __align__(16) float smem[];
  const int Q = A.Q, P = A.P, N = A.N;
  // C [TILE][LDB], B [TS][LDB] (a state block: two B tiles there), two
  // x [TS][LDX], then cum and dt of the block's heads
  float* const xs = smem + (TILE + TS) * LDB;
  float* const cum = xs + 2 * TS * LDX;  // [HB][Q]
  float* const dts = cum + HB * Q;         // [HB][Q]

  // block roles, heaviest first so that the block scheduler balances the
  // causal work: y of q tiles nq-1 .. 1 (per chunk and head block), the
  // chunk state of one head, y of q tile 0
  const int nq = (Q + TILE - 1) / TILE;
  const int nhb = (A.H + HB - 1) / HB;
  const int n_late = A.BC * nhb * (nq - 1);
  int b = blockIdx.x, qt = 0, c, h0, nh;
  bool state = false;
  if (b < n_late || b >= n_late + A.BC * A.H) {
    if (b < n_late) {
      qt = nq - 1 - b / (A.BC * nhb);
      b %= A.BC * nhb;
    } else {
      b -= n_late + A.BC * A.H;
    }
    c = b / nhb;
    h0 = (b % nhb) * HB;
    nh = min(HB, A.H - h0);
  } else {
    state = true;
    b -= n_late;
    c = b / A.H;
    h0 = b % A.H;
    nh = 1;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;

  const float* xc = A.x + c * A.xsb;
  const float* bc = A.bm + c * A.bsb;

  // dt, and cum = cumsum(dt * a), of the block's heads
  const float* db = A.dt + c * A.dsb + h0;
  for (int e = threadIdx.x; e < nh * Q; e += THREADS) {
    const int s = e / nh, hl = e % nh;
    dts[hl * Q + s] = db[s * A.dsq + hl];
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    const int hl = threadIdx.x;
    const float ah = A.a[h0 + hl];
    float run = 0.f;
#pragma unroll 8
    for (int s = 0; s < Q; ++s) {
      run = run + __fmul_rn(dts[hl * Q + s], ah);  // round dt*a first
      cum[hl * Q + s] = run;
    }
    if (state) A.g[static_cast<int64_t>(c) * A.H + h0] = expf(run);
  }
  // (the loops below meet a __syncthreads before reading cum)

  if (!state) {
    // ---- y of q tile qt: steps (s tile, head).  The C tile stays for the
    // block; the B tile of s tile ts + 1 loads once C.B^T of ts is done; a
    // step's x tile loads during the step before.
    float* const Cs = smem;
    float* const Bs = smem + TILE * LDB;
    float acc[HB][8][4];  // y: 16 q rows x 64 p of each head
    float cbt[KS][4];     // C.B^T: 16 q rows x TS s
#pragma unroll
    for (int h = 0; h < HB; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][j][i] = 0.f;
    auto load_x = [&](int s_t, int h, int buf) {
      load_tile<TS, TILE, LDX>(xs + buf * TS * LDX, xc + (h0 + h) * A.xsh,
                               s_t * TS, Q, P, A.xsq, A.vx);
    };
    load_tile<TILE, NP, LDB>(Cs, A.cm + c * A.csb, qt * TILE, Q, N, A.csq,
                             A.vc);
    load_tile<TS, NP, LDB>(Bs, bc, 0, Q, N, A.bsq, A.vb);
    load_x(0, 0, 0);
    cp_async_commit();
    const int r0 = 16 * warp + gq;  // the lane's rows r0, r0 + 8 of the tile
    const int q0 = qt * TILE + r0, q1 = q0 + 8;
    // s tiles up to the q tile's last row
    const int n_st = (min((qt + 1) * TILE, Q) + TS - 1) / TS;
    int ts = 0, hh = 0;
    for (int step = 0; ts < n_st; ++step) {
      int ns = ts, nh2 = hh + 1;  // the next step
      if (nh2 == nh) {
        nh2 = 0;
        ++ns;
      }
      if (ns < n_st) load_x(ns, nh2, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (hh == 0) {  // C.B^T of (q tile, s tile), once for all heads
#pragma unroll
        for (int j = 0; j < KS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) cbt[j][i] = 0.f;
#pragma unroll 4
        for (int k0 = 0; k0 < NP; k0 += 8) {
          // k order (2t, 2t + 1) as (t, t + 4) of both fragments
          const int k = k0 + 2 * tq;
          const float2 ca = *reinterpret_cast<const float2*>(Cs + r0 * LDB + k);
          const float2 cb =
              *reinterpret_cast<const float2*>(Cs + (r0 + 8) * LDB + k);
          uint32_t ah[4], al[4];
          split_a(ca.x, cb.x, ca.y, cb.y, ah, al);
#pragma unroll
          for (int j = 0; j < KS; ++j) {
            const float2 bv = *reinterpret_cast<const float2*>(
                Bs + (8 * j + gq) * LDB + k);
            mma_3xtf32(cbt[j], ah, al, bv.x, bv.y);
          }
        }
        __syncthreads();  // every warp is done with Bs
        if (ts + 1 < n_st)
          load_tile<TS, NP, LDB>(Bs, bc, (ts + 1) * TS, Q, N, A.bsq, A.vb);
        cp_async_commit();
      }
      const float* Xs = xs + (step & 1) * TS * LDX;
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        if (h != hh) continue;
        // M_h = select(s <= q, CB exp(cum_q - cum_s) dt_s, 0); y += M_h x
        const float* cu = cum + h * Q;
        const float* dh = dts + h * Q;
        const float cq0 = q0 < Q ? cu[q0] : 0.f;
        const float cq1 = q1 < Q ? cu[q1] : 0.f;
#pragma unroll
        for (int kb = 0; kb < KS; ++kb) {
          const int s = ts * TS + 8 * kb + 2 * tq;
          const bool in0 = s < Q, in1 = s + 1 < Q;
          const float cs0 = in0 ? cu[s] : 0.f, cs1 = in1 ? cu[s + 1] : 0.f;
          const float d0 = in0 ? dh[s] : 0.f, d1 = in1 ? dh[s + 1] : 0.f;
          // select, never multiply by the mask (exp overflows to inf above
          // the diagonal): masked exponents are -inf, and exp(-inf) = 0
          const float m00 = cbt[kb][0] * d0 *
                            expf(q0 < Q && s <= q0 ? cq0 - cs0 : -INFINITY);
          const float m01 = cbt[kb][1] * d1 *
                            expf(q0 < Q && s < q0 ? cq0 - cs1 : -INFINITY);
          const float m10 = cbt[kb][2] * d0 *
                            expf(q1 < Q && s <= q1 ? cq1 - cs0 : -INFINITY);
          const float m11 = cbt[kb][3] * d1 *
                            expf(q1 < Q && s < q1 ? cq1 - cs1 : -INFINITY);
          uint32_t ah[4], al[4];
          split_a(m00, m10, m01, m11, ah, al);
          const float* xr = Xs + (8 * kb + 2 * tq) * LDX + gq;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mma_3xtf32(acc[h][j], ah, al, xr[8 * j], xr[LDX + 8 * j]);
        }
      }
      __syncthreads();  // this x buffer's reads done before it is refilled
      ts = ns;
      hh = nh2;
    }
    const bool even = (P & 1) == 0;
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      if (h >= nh) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * tq;
        if (p >= P) continue;
        float* y0 = A.y + ((static_cast<int64_t>(c) * Q + q0) * A.H + h0 +
                           h) * P + p;
        if (q0 < Q) store2(y0, acc[h][j][0], acc[h][j][1], P - p, even);
        if (q1 < Q)
          store2(y0 + static_cast<int64_t>(8) * A.H * P, acc[h][j][2],
                 acc[h][j][3], P - p, even);
      }
    }
  } else {
    // ---- the chunk state of head h0: steps (s tile), the B and x tiles
    // double-buffered; st^T = B^T (x w), w_s = exp(cum_{Q-1} - cum_s) dt_s.
    // Warp w owns n rows w NP / 4 .. (w + 1) NP / 4 - 1 (MT m16 tiles) and
    // all 64 p, so it splits only its quarter of each B tile.
    constexpr int MT = NP / 64;
    float acc[MT][8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
    auto issue = [&](int s_t, int buf) {
      load_tile<TS, NP, LDB>(smem + buf * TS * LDB, bc, s_t * TS, Q, N,
                             A.bsq, A.vb);
      load_tile<TS, TILE, LDX>(xs + buf * TS * LDX, xc + h0 * A.xsh,
                               s_t * TS, Q, P, A.xsq, A.vx);
    };
    issue(0, 0);
    cp_async_commit();
    const int n0 = warp * (NP / 4);
    const int n_st = (Q + TS - 1) / TS;
    for (int ts = 0; ts < n_st; ++ts) {
      if (ts + 1 < n_st) issue(ts + 1, (ts + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* Bs = smem + (ts & 1) * TS * LDB;
      const float* Xs = xs + (ts & 1) * TS * LDX;
      const float last = cum[Q - 1];
#pragma unroll 2
      for (int kb = 0; kb < KS; ++kb) {
        const int s = ts * TS + 8 * kb + 2 * tq;
        const float w0 = s < Q ? expf(last - cum[s]) * dts[s] : 0.f;
        const float w1 =
            s + 1 < Q ? expf(last - cum[s + 1]) * dts[s + 1] : 0.f;
        const float* br = Bs + (8 * kb + 2 * tq) * LDB + n0 + gq;
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          split_a(br[16 * m], br[16 * m + 8], br[LDB + 16 * m],
                  br[LDB + 16 * m + 8], ah[m], al[m]);
        const float* xr = Xs + (8 * kb + 2 * tq) * LDX + gq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(xr[8 * j] * w0, bh0, bl0);
          split_tf32(xr[LDX + 8 * j] * w1, bh1, bl1);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            mma_3xtf32(acc[m][j], ah[m], al[m], bh0, bh1, bl0, bl1);
        }
      }
      __syncthreads();
    }
    float* sb = A.st + (static_cast<int64_t>(c) * A.H + h0) * P * N;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 16 * m + gq, p = 8 * j + 2 * tq;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ni = n + 8 * (i >> 1), pi = p + (i & 1);
          if (ni < N && pi < P) sb[static_cast<int64_t>(pi) * N + ni] =
              acc[m][j][i];
        }
      }
  }
}

template <int NP>
int launch(const Args& A, cudaStream_t s) {
  // hb_max heads a block while the tiles and cum / dt fit, else one
  constexpr int HB = hb_max<NP>();
  const int hb = smem_bytes<NP>(HB, A.Q) <= SMEM_MAX ? HB : 1;
  const size_t smem = smem_bytes<NP>(hb, A.Q);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = hb == HB ? ssd_chunk_fwd<NP, HB> : ssd_chunk_fwd<NP, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // y blocks (chunk, head block, q tile) and state blocks (chunk, head)
  const int64_t nq = (A.Q + TILE - 1) / TILE;
  const int64_t grid = static_cast<int64_t>(A.BC) *
                       (((A.H + hb - 1) / hb) * nq + A.H);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(A);
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
      N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Args A{x, dt, a, bm, cm, y, st, g, BC, H, Q, P, N,
               xsb, xsq, xsh, dsb, dsq, bsb, bsq, csb, csq,
               al16(x) && xsb % 4 == 0 && xsq % 4 == 0 && xsh % 4 == 0 &&
                   P % 4 == 0,
               al16(bm) && bsb % 4 == 0 && bsq % 4 == 0 && N % 4 == 0,
               al16(cm) && csb % 4 == 0 && csq % 4 == 0 && N % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64) return launch<64>(A, s);
  if (N <= 128) return launch<128>(A, s);
  return launch<256>(A, s);
}

}  // extern "C"
