// Mamba-2 SSD intra-chunk backward for Hopper (sm_90a).
//
// The gradients of the intra-chunk pass in csrc/ssd.cu.  It has no Pallas
// counterpart: the reference differentiates its jnp SSD path
// (src/repro/models/ssm.py:ssd_chunked) with JAX's autodiff.  The math is
// kernels/ssd/ref.py:ssd_intra_chunk_bwd_ref's.  For every chunk c and
// head h, with cum the prefix sum of dt * a[h] over the chunk,
//
//   L[q,s] = select(s <= q, exp(cum_q - cum_s), 0)      CB = C B^T
//   M = CB * L * dt_s   (y = M x)      w_s = exp(cum_{Q-1} - cum_s) dt_s
//   dM = dy x^T  (s <= q)               E = B dst^T   ([Q, P])
//   dx = M^T dy + w_s E                 dw_s = sum_p x[s,p] E[s,p]
//   dCB = sum_h dM * L * dt_s           dC = dCB B     dB = dCB^T C
//                                                      + sum_h w_s x_h^T dst_h
//   T = dM * CB * L: ddt_s gets sum_q T + dw_s exp(cum_{Q-1} - cum_s) and
//   a times the reverse cumsum of dcum, where dcum gathers
//   +sum_{s<q} T dt_s (q side), -dt_s sum_{q>s} T (s side), -dw_s w_s at
//   s < Q - 1, sum_{s<Q-1} dw_s w_s + dg g at Q - 1;  da = sum (reverse
//   cumsum) * dt.  The pairs whose exponent is identically 0 (s = q; s =
//   Q - 1 in w) are left out of dcum: their two sides cancel exactly, and
//   summed apart their rounding residue would swamp the ~1e-5 smaller
//   terms that reach cum at large decays.
//
// What bounds it on this card: at mamba2-780m's train shape (8 chunk rows
// of Q = 256, H = 48, P = 64, N = 128) one call needs ~6.7 GFLOP counting
// the causal pairs only, and moves ~90 MB (zamba2-2.7b: ~8.2 GFLOP,
// ~140 MB).  Its products run here in fp32 on the CUDA cores (67 TFLOP/s),
// so operations bound it at ~0.1 ms; a 3xTF32 or wgmma design is a later
// step (ROADMAP.md B).
//
// Design (a first, simple kernel; fp32 throughout, no atomics, so the
// gradients are deterministic):
//   * Five kernels in stream order.  ssd_bwd_cb: C.B^T per chunk, once
//     for all heads, in 64 x 64 lower-triangle tiles.  ssd_bwd_main, per
//     (s tile, chunk, head block of HB heads): for each head and each q
//     tile at or below the diagonal, dM, M, T and dM * L * dt_s of the
//     64 x 64 tile; dx of the s tile accumulates M^T dy in registers;
//     dM * L * dt_s is summed over the block's heads into a per-(chunk,
//     head block) scratch before any product with B or C; row sums of
//     T dt_s go to scratch per s tile, column sums stay in the block.
//     Then the state's terms E, dx and dw.  ssd_bwd_dt, per (chunk, head):
//     dcum, its reverse cumsum, ddt and the (chunk, head) partial of da.
//     ssd_bwd_dc and ssd_bwd_db, per (head block, chunk, 64-row tile,
//     64-column n tile): dC = dCB B and dB = dCB^T C + sum_h (w x_h)^T
//     dst_h, each a partial over head blocks.  The wrapper
//     (kernels/ssd/ops.py) sums the head-block partials of dB and dC and
//     the chunk partials of da in torch: sums in a fixed order, no product.
//   * Each tile product is 256 threads of 4 x 4 outputs over shared-memory
//     tiles of pitch 65 floats (odd), so row and column reads are both
//     free of bank conflicts.  At 8 chunk rows the grids are 80
//     (ssd_bwd_cb) to 768 blocks, heaviest first where the causal work
//     differs.
//   * The decay is selected with the causal mask, never multiplied by it:
//     exp(cum_q - cum_s) overflows to inf above the diagonal, and a select
//     after the exp would make 0 * inf = NaN.  Masked exponents are -inf.
//   * cum is the forward kernel's: a sequential fp32 sum of
//     __fmul_rn(dt, a) in one thread per head.
//   * Inputs are read through their strides (unit stride on the last dim),
//     as the forward reads them; ragged Q, P <= 64 and N <= 256 are masked
//     by zero-filled tile loads and guarded stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int T = 64;         // tile rows and columns
constexpr int LD = T + 1;     // odd pitch: rows and columns conflict-free
constexpr int TILE = T * LD;  // floats of one tile
constexpr int HB = 4;         // heads a block (ssd_bwd_main, ssd_bwd_db)
constexpr int MAX_P = 64;
constexpr int MAX_N = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use

struct Args {
  const float *x, *dt, *a, *bm, *cm, *dy, *dst, *dg;
  float *dx, *ddt, *da_part, *db_part, *dc_part;
  // scratch: C.B^T [BC][Q][Q]; the head-block sums of dM * L * dt_s
  // [BC][nhb][Q][Q]; row sums of T dt_s [BC][H][nq][Q]; per s the ddt
  // terms and the s-side dcum terms [BC][H][Q]; per s tile the dcum term
  // at Q - 1 [BC][H][nq]
  float *cb, *dcb, *rowsum, *sdir, *scum, *slast;
  int BC, Q, H, P, N, nq, nhb;
  int64_t xsb, xsq, xsh, dsb, dsq, bsb, bsq, csb, csq;
};

// rows [r0, r0 + T) x columns [c0, c0 + T) of a row-major matrix (row
// pitch ld, unit column stride) into a [T][LD] tile, zero outside
// [0, rows) x [0, cols); each row times scale[r] where scale is given.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int c0, int cols,
                                          int64_t ld,
                                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int r = e / T, k = e % T;
    const int gr = r0 + r, gc = c0 + k;
    float v = (gr < rows && gc < cols)
                  ? src[static_cast<int64_t>(gr) * ld + gc]
                  : 0.f;
    if (scale) v *= scale[r];
    dst[r * LD + k] = v;
  }
}

// acc[i][j] += sum_k A(ty + 16 i, k) B(k, tx + 16 j) over the tile's 64 k,
// A(r, k) = AT ? a[k][r] : a[r][k] and B(k, c) = BT ? b[c][k] : b[k][c].
template <bool AT, bool BT>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], const float* a,
                                        const float* b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = AT ? a[k * LD + ty + 16 * i] : a[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = BT ? b[(tx + 16 * j) * LD + k] : b[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// the sum over the 16 lanes that share a tile row (half a warp); every
// thread of the block calls it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dt and cum = cumsum(dt * a) of heads h0 .. h0 + nh - 1 of chunk c into
// dts[hl][Q] and cum[hl][Q]: a sequential fp32 sum in one thread per head,
// the forward kernel's order.  Every thread calls it.
__device__ void block_cum(float* cum, float* dts, const Args& A, int c,
                          int h0, int nh) {
  const int Q = A.Q;
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
    for (int s = 0; s < Q; ++s) {
      run = run + __fmul_rn(dts[hl * Q + s], ah);
      cum[hl * Q + s] = run;
    }
  }
  __syncthreads();
}

// C.B^T of chunk c in lower-triangle tile pairs (q tile >= s tile)
__global__ void __launch_bounds__(THREADS) ssd_bwd_cb(const Args A) {
  __shared__ float cs[TILE], bs[TILE];
  const int npair = A.nq * (A.nq + 1) / 2;
  const int c = blockIdx.x / npair;
  int st = blockIdx.x % npair, qt = 0;
  while (st > qt) {
    st -= qt + 1;
    ++qt;
  }
  float acc[4][4];
  zero(acc);
  for (int n0 = 0; n0 < A.N; n0 += T) {
    load_tile(cs, A.cm + c * A.csb, qt * T, A.Q, n0, A.N, A.csq);
    load_tile(bs, A.bm + c * A.bsb, st * T, A.Q, n0, A.N, A.bsq);
    __syncthreads();
    tile_mm<false, true>(acc, cs, bs);
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = qt * T + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = st * T + tx + 16 * j;
      if (q < A.Q && s < A.Q)
        A.cb[(static_cast<int64_t>(c) * A.Q + q) * A.Q + s] = acc[i][j];
    }
  }
}

// per (s tile, chunk, head block): dx of the s tile, the head-block sum
// of dM * L * dt_s, and the dcum / ddt terms of the s tile
__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_main(const Args A) {
  extern __shared__ float sm[];
  float* const xs = sm;           // x of the head, s tile [s][p]
  float* const dys = xs + TILE;   // dy of the head, q tile [q][p]; B [s][n]
  float* const cbs = dys + TILE;  // C.B^T tile [q][s]; dst [p][n]
  float* const ms = cbs + TILE;   // M tile [q][s]
  float* const red = ms + TILE;   // [16][T] column partial sums of T
  float* const redo = red + 16 * T;  // [16][T] the same over q > s
  float* const colt = redo + 16 * T;  // [T] sum_q T of the s tile
  float* const colto = colt + T;      // [T] sum_{q>s} T
  float* const dws = colto + T;       // [T] dw_s, then dw_s w_s
  float* const cum = dws + T;        // [HB][Q]
  float* const dts = cum + HB * A.Q;  // [HB][Q]

  const int Q = A.Q, P = A.P, H = A.H;
  const int per_st = A.BC * A.nhb;
  const int st = blockIdx.x / per_st;  // s tile 0 (the most q tiles) first
  const int c = (blockIdx.x % per_st) / A.nhb;
  const int hb = blockIdx.x % A.nhb;
  const int h0 = hb * HB, nh = min(HB, H - h0);
  const int s0 = st * T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  block_cum(cum, dts, A, c, h0, nh);
  float* const dcbp =
      A.dcb + (static_cast<int64_t>(c) * A.nhb + hb) * Q * Q;

  for (int hl = 0; hl < nh; ++hl) {
    const int h = h0 + hl;
    const int64_t ch = static_cast<int64_t>(c) * H + h;
    const float* const cu = cum + hl * Q;
    const float* const dh = dts + hl * Q;
    load_tile(xs, A.x + c * A.xsb + h * A.xsh, s0, Q, 0, P, A.xsq);
    if (threadIdx.x < T) colt[threadIdx.x] = colto[threadIdx.x] = 0.f;
    float cs[4], ds[4];
    bool sin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + tx + 16 * j;
      sin[j] = s < Q;
      cs[j] = sin[j] ? cu[s] : 0.f;
      ds[j] = sin[j] ? dh[s] : 0.f;
    }
    float dx[4][4];
    zero(dx);
    for (int qt = st; qt < A.nq; ++qt) {
      const int q0 = qt * T;
      load_tile(dys, A.dy + (static_cast<int64_t>(c) * Q * H + h) * P, q0, Q,
                0, P, static_cast<int64_t>(H) * P);
      load_tile(cbs, A.cb + static_cast<int64_t>(c) * Q * Q, q0, Q, s0, Q,
                Q);
      __syncthreads();
      float dm[4][4];
      zero(dm);
      tile_mm<false, true>(dm, dys, xs);  // dM[q][s] = sum_p dy x
      float colp[4] = {0.f, 0.f, 0.f, 0.f}, colo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = ty + 16 * i, q = q0 + ql;
        const bool qin = q < Q;
        const float cq = qin ? cu[q] : 0.f;
        float rowp = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = tx + 16 * j, s = s0 + sl;
          // select the exponent, never multiply by the mask: exp(cum_q -
          // cum_s) overflows to inf above the diagonal
          const float l =
              expf(qin && sin[j] && s <= q ? cq - cs[j] : -INFINITY);
          const float cbv = cbs[ql * LD + sl];
          const float ldt = l * ds[j];
          ms[ql * LD + sl] = cbv * ldt;
          const float t = dm[i][j] * cbv * l;
          const float to = s < q ? t : 0.f;  // off the diagonal
          rowp += to * ds[j];
          colp[j] += t;
          colo[j] += to;
          if (qin && sin[j]) {  // this thread owns (q, s) for every head
            float* const pp = dcbp + static_cast<int64_t>(q) * Q + s;
            const float v = dm[i][j] * ldt;
            *pp = hl == 0 ? v : *pp + v;
          }
        }
        rowp = row_sum16(rowp);
        if (tx == 0 && qin)
          A.rowsum[(ch * A.nq + st) * Q + q] = rowp;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[ty * T + tx + 16 * j] = colp[j];
        redo[ty * T + tx + 16 * j] = colo[j];
      }
      __syncthreads();
      if (threadIdx.x < T) {
        float v = 0.f, vo = 0.f;
        for (int y = 0; y < 16; ++y) {
          v += red[y * T + threadIdx.x];
          vo += redo[y * T + threadIdx.x];
        }
        colt[threadIdx.x] += v;
        colto[threadIdx.x] += vo;
      }
      tile_mm<true, false>(dx, ms, dys);  // dx[s][p] += sum_q M dy
      __syncthreads();
    }

    // the state's terms: E[s][p] = sum_n B[s][n] dst[p][n]
    float e[4][4];
    zero(e);
    const float* const dsth = A.dst + ch * P * A.N;
    for (int n0 = 0; n0 < A.N; n0 += T) {
      load_tile(dys, A.bm + c * A.bsb, s0, Q, n0, A.N, A.bsq);
      load_tile(cbs, dsth, 0, P, n0, A.N, A.N);
      __syncthreads();
      tile_mm<false, true>(e, dys, cbs);
      __syncthreads();
    }
    const float last = cu[Q - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = ty + 16 * i, s = s0 + sl;
      const bool in = s < Q;
      const float w = in ? expf(last - cu[s]) * dh[s] : 0.f;
      float dwp = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        dx[i][j] += w * e[i][j];
        dwp += xs[sl * LD + p] * e[i][j];
        if (in && p < P)
          A.dx[((static_cast<int64_t>(c) * Q + s) * H + h) * P + p] =
              dx[i][j];
      }
      dwp = row_sum16(dwp);
      if (tx == 0) dws[sl] = dwp;
    }
    __syncthreads();
    if (threadIdx.x < T) {
      const int sl = threadIdx.x, s = s0 + sl;
      float dww = 0.f;
      if (s < Q) {
        const float es = expf(last - cu[s]);
        const float w = es * dh[s];
        const float dw = dws[sl];
        A.sdir[ch * Q + s] = colt[sl] + dw * es;
        dww = s < Q - 1 ? dw * w : 0.f;  // s = Q - 1: exponent 0
        A.scum[ch * Q + s] = -dh[s] * colto[sl] - dww;
      }
      dws[sl] = dww;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int sl = 0; sl < T; ++sl) v += dws[sl];
      A.slast[ch * A.nq + st] = v;
    }
    __syncthreads();  // colt, dws and xs are the next head's
  }
}

// per (chunk, head): dcum, its reverse cumsum, ddt and da's partial
__global__ void __launch_bounds__(THREADS) ssd_bwd_dt(const Args A) {
  extern __shared__ float sm[];
  const int Q = A.Q;
  float* const dts = sm;
  float* const cum = dts + Q;
  float* const dcum = cum + Q;
  const int c = blockIdx.x / A.H, h = blockIdx.x % A.H;
  const int64_t ch = static_cast<int64_t>(c) * A.H + h;
  block_cum(cum, dts, A, c, h, 1);
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    float v = A.scum[ch * Q + q];
    for (int st = 0; st <= q / T; ++st)  // the s tiles that reach row q
      v += A.rowsum[(ch * A.nq + st) * Q + q];
    dcum[q] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int st = 0; st < A.nq; ++st) v += A.slast[ch * A.nq + st];
    dcum[Q - 1] += v + A.dg[ch] * expf(cum[Q - 1]);
    // cum = cumsum(dt a): d loss / d (dt a)_s is the reverse cumsum
    float run = 0.f, da = 0.f;
    for (int s = Q - 1; s >= 0; --s) {
      run += dcum[s];
      dcum[s] = run;
      da += run * dts[s];
    }
    A.da_part[ch] = da;
  }
  __syncthreads();
  const float ah = A.a[h];
  for (int s = threadIdx.x; s < Q; s += THREADS)
    A.ddt[(static_cast<int64_t>(c) * Q + s) * A.H + h] =
        A.sdir[ch * Q + s] + ah * dcum[s];
}

// per (q tile, head block, chunk, n tile): dC's head-block partial,
// sum_{s <= q} dCB[q][s] B[s][n]
__global__ void __launch_bounds__(THREADS) ssd_bwd_dc(const Args A) {
  __shared__ float as[TILE], bs[TILE];
  const int Q = A.Q, nn = (A.N + T - 1) / T;
  const int per_qt = A.nhb * A.BC * nn;
  const int qt = A.nq - 1 - blockIdx.x / per_qt;  // the most s tiles first
  int b = blockIdx.x % per_qt;
  const int nt = b % nn;
  b /= nn;
  const int c = b % A.BC, hb = b / A.BC;
  const float* const dcbp =
      A.dcb + (static_cast<int64_t>(c) * A.nhb + hb) * Q * Q;
  float acc[4][4];
  zero(acc);
  for (int st = 0; st <= qt; ++st) {
    load_tile(as, dcbp, qt * T, Q, st * T, Q, Q);
    load_tile(bs, A.bm + c * A.bsb, st * T, Q, nt * T, A.N, A.bsq);
    __syncthreads();
    tile_mm<false, false>(acc, as, bs);
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* const out =
      A.dc_part + (static_cast<int64_t>(hb) * A.BC + c) * Q * A.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = qt * T + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nt * T + tx + 16 * j;
      if (q < Q && n < A.N) out[static_cast<int64_t>(q) * A.N + n] =
          acc[i][j];
    }
  }
}

// per (s tile, head block, chunk, n tile): dB's head-block partial,
// sum_{q >= s} dCB[q][s] C[q][n] + sum_h sum_p w_s x_h[s][p] dst_h[p][n]
__global__ void __launch_bounds__(THREADS) ssd_bwd_db(const Args A) {
  extern __shared__ float sm[];
  float* const as = sm;
  float* const bs = as + TILE;
  float* const wv = bs + TILE;       // [T]
  float* const cum = wv + T;         // [HB][Q]
  float* const dts = cum + HB * A.Q;  // [HB][Q]
  const int Q = A.Q, P = A.P, nn = (A.N + T - 1) / T;
  const int per_st = A.nhb * A.BC * nn;
  const int st = blockIdx.x / per_st;  // s tile 0 (the most q tiles) first
  int b = blockIdx.x % per_st;
  const int nt = b % nn;
  b /= nn;
  const int c = b % A.BC, hb = b / A.BC;
  const int h0 = hb * HB, nh = min(HB, A.H - h0);
  const int s0 = st * T;
  const float* const dcbp =
      A.dcb + (static_cast<int64_t>(c) * A.nhb + hb) * Q * Q;
  float acc[4][4];
  zero(acc);
  for (int qt = st; qt < A.nq; ++qt) {
    load_tile(as, dcbp, qt * T, Q, s0, Q, Q);  // dCB [q][s]
    load_tile(bs, A.cm + c * A.csb, qt * T, Q, nt * T, A.N, A.csq);
    __syncthreads();
    tile_mm<true, false>(acc, as, bs);
    __syncthreads();
  }
  block_cum(cum, dts, A, c, h0, nh);
  for (int hl = 0; hl < nh; ++hl) {
    const int h = h0 + hl;
    if (threadIdx.x < T) {
      const int s = s0 + threadIdx.x;
      const float* cu = cum + hl * Q;
      wv[threadIdx.x] = s < Q ? expf(cu[Q - 1] - cu[s]) * dts[hl * Q + s]
                              : 0.f;
    }
    __syncthreads();
    load_tile(as, A.x + c * A.xsb + h * A.xsh, s0, Q, 0, P, A.xsq, wv);
    load_tile(bs, A.dst + (static_cast<int64_t>(c) * A.H + h) * P * A.N, 0,
              P, nt * T, A.N, A.N);
    __syncthreads();
    tile_mm<false, false>(acc, as, bs);
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* const out =
      A.db_part + (static_cast<int64_t>(hb) * A.BC + c) * Q * A.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nt * T + tx + 16 * j;
      if (s < Q && n < A.N) out[static_cast<int64_t>(s) * A.N + n] =
          acc[i][j];
    }
  }
}

struct Sizes {
  int64_t nq, nhb, cb, dcb, rowsum, per_s, slast;
};

Sizes sizes(int BC, int Q, int H) {
  Sizes z;
  z.nq = (Q + T - 1) / T;
  z.nhb = (H + HB - 1) / HB;
  z.cb = static_cast<int64_t>(BC) * Q * Q;
  z.dcb = z.cb * z.nhb;
  z.rowsum = static_cast<int64_t>(BC) * H * z.nq * Q;
  z.per_s = static_cast<int64_t>(BC) * H * Q;
  z.slast = static_cast<int64_t>(BC) * H * z.nq;
  return z;
}

int set_smem(const void* kern, size_t bytes) {
  if (bytes > static_cast<size_t>(SMEM_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = head blocks (the leading dim of the dB and dC partials),
// out[1] = fp32 elements of the scratch buffer.
void ssd_intra_chunk_bwd_sizes(int BC, int Q, int H, int64_t* out) {
  const Sizes z = sizes(BC, Q, H);
  out[0] = z.nhb;
  out[1] = z.cb + z.dcb + z.rowsum + 2 * z.per_s + z.slast;
}

// Inputs as ssd_intra_chunk_launch takes them (x [BC, Q, H, P], dt
// [BC, Q, H], B and C [BC, Q, N] by their strides, unit stride on the last
// dim; a [H] contiguous); dy [BC, Q, H, P], dst [BC, H, P, N] and dg
// [BC, H] contiguous.  Writes contiguous dx [BC, Q, H, P], ddt [BC, Q, H],
// da_part [BC, H] (da's partial per chunk), db_part and dc_part
// [nhb, BC, Q, N] (partials per head block); scratch holds the count of
// floats that ssd_intra_chunk_bwd_sizes gives.  Returns the first CUDA
// error of the five launches (0 = launched).
int ssd_intra_chunk_bwd_launch(
    const float* x, const float* dt, const float* a, const float* bm,
    const float* cm, const float* dy, const float* dst, const float* dg,
    float* dx, float* ddt, float* da_part, float* db_part, float* dc_part,
    float* scratch, int BC, int Q, int H, int P, int N, int64_t xsb,
    int64_t xsq, int64_t xsh, int64_t dsb, int64_t dsq, int64_t bsb,
    int64_t bsq, int64_t csb, int64_t csq, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 ||
      N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sizes z = sizes(BC, Q, H);
  float* const cb = scratch;
  float* const dcb = cb + z.cb;
  float* const rowsum = dcb + z.dcb;
  float* const sdir = rowsum + z.rowsum;
  float* const scum = sdir + z.per_s;
  float* const slast = scum + z.per_s;
  const Args A{x, dt, a, bm, cm, dy, dst, dg, dx, ddt, da_part, db_part,
               dc_part, cb, dcb, rowsum, sdir, scum, slast, BC, Q, H, P, N,
               static_cast<int>(z.nq), static_cast<int>(z.nhb), xsb, xsq,
               xsh, dsb, dsq, bsb, bsq, csb, csq};
  const int64_t nn = (N + T - 1) / T;
  const int64_t grids[5] = {BC * z.nq * (z.nq + 1) / 2, z.nq * BC * z.nhb,
                            static_cast<int64_t>(BC) * H,
                            z.nq * z.nhb * BC * nn, z.nq * z.nhb * BC * nn};
  for (int64_t g : grids)
    if (g > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t sm_main =
      sizeof(float) * (4 * TILE + 35 * T + 2 * static_cast<size_t>(HB) * Q);
  const size_t sm_dt = sizeof(float) * 3 * static_cast<size_t>(Q);
  const size_t sm_db =
      sizeof(float) * (2 * TILE + T + 2 * static_cast<size_t>(HB) * Q);
  int err = set_smem(reinterpret_cast<const void*>(ssd_bwd_main), sm_main);
  if (!err) err = set_smem(reinterpret_cast<const void*>(ssd_bwd_dt), sm_dt);
  if (!err) err = set_smem(reinterpret_cast<const void*>(ssd_bwd_db), sm_db);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_bwd_cb<<<static_cast<unsigned>(grids[0]), THREADS, 0, s>>>(A);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_bwd_main<<<static_cast<unsigned>(grids[1]), THREADS, sm_main, s>>>(A);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_bwd_dt<<<static_cast<unsigned>(grids[2]), THREADS, sm_dt, s>>>(A);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_bwd_dc<<<static_cast<unsigned>(grids[3]), THREADS, 0, s>>>(A);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  ssd_bwd_db<<<static_cast<unsigned>(grids[4]), THREADS, sm_db, s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
