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
// the causal pairs and the chunk-level products (C.B^T, dCB.B, dCB^T.C)
// once per chunk, and moves ~93 MB (zamba2-2.7b: ~8.2 GFLOP, ~140 MB).  At
// fp32 accuracy on the tensor cores (495 TF32 TFLOP/s over a 3xTF32
// split) that is 40 / 50 us of operations beside 28 / 42 us of bytes:
// operations bound it.  Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): ~0.41 ms (mamba2) and ~0.52 ms (zamba2), ~10 % of that
// bound, and ~25 % of the rate its mma.sync instructions allow (322 TF32
// TFLOP/s, scripts/mma_rate.py).  Every product phase (C.B^T, dM, dx,
// the state's E and dB terms) costs about the same per mma.sync issued,
// and neither a second accumulator chain per output, four heads a block
// nor conflict-free row pitches moved it (PERF.md §6), so neither the
// tensor pipe, mma latency nor bank conflicts is what holds it; the next
// step is wgmma, whose warpgroup tiles read shared operands once.
//
// Design (no float atomics: every cross-block sum is taken in a fixed
// order, so the gradients are bitwise repeatable):
//   * Two launches.  ssd_bwd_main, one 256-thread block per (s tile of 64
//     rows, chunk, head block of HB = 2 heads; s tile 0, which meets the
//     most q tiles, first): for each q tile at or below the diagonal it
//     forms the 64 x 64 tile of C.B^T once and applies it to its heads:
//     dM^T, M^T and T of each head, dx += M^T dy, the column sums of T (s
//     side) in registers and its row sums (q side) to a small scratch,
//     and dM * L * dt summed over the heads in registers, written as the
//     head block's dCB^T tile.  Then per head the state's terms (E, dx,
//     dw, and the head block's share of (w x)^T dst for dB), with both
//     heads' dst tiles loaded at once.  The last block of a (chunk, s
//     tile) to finish (an integer arrival counter) sums the head blocks'
//     dCB^T tiles in head-block order.  ssd_bwd_fin: per (chunk, s tile,
//     32 columns of N) dB = dCB^T C plus the head blocks' state terms (the
//     column split spreads the reads of those partials over more blocks),
//     per (chunk, q tile, 32 columns) dC = dCB B, and per (chunk, head)
//     dcum, its reverse cumsum, ddt and da's chunk partial, the last chunk
//     of a head summing da in chunk order.
//   * Warps: warp w owns s rows 16 (w % 4) .. + 15 of the tile, and q
//     columns (for C.B^T, dM^T, T) or p columns (for dx and E) 32 (w / 4)
//     .. + 31, so each warp keeps 16 x 32 accumulators a head: dx of the
//     block's heads stays in registers across the q tiles.  M^T goes to
//     shared memory between the two warps that share its rows (a named
//     barrier), and is read back as the A fragment of dx += M^T dy.
//   * Products on mma.sync m16n8k8 tf32 with the 3xTF32 split (hopper.cuh),
//     fp32 sums.  The k order inside an m16n8k8 product is free, so rows
//     of a row-major shared tile feed the A and B fragments with one
//     8-byte read: k = 2t and 2t + 1 as fragment slots t and t + 4.  Each
//     step's dy tile, read by all eight warps, is split into tf32 hi / lo
//     planes once (N <= 128, where shared memory holds the second plane).
//   * Loads by cp.async: B of the s tile and x of the block's heads once;
//     each step's dy tile during the step before; the next C tile once
//     C.B^T is done with the current one.  Rows that are not 16-byte
//     aligned load scalars into the same layout; ragged Q, P, N and H are
//     zero-filled or masked.
//   * The decay is selected with the causal mask, never multiplied by it:
//     exp(cum_q - cum_s) overflows to inf above the diagonal, and a select
//     after the exp would make 0 * inf = NaN.  Masked exponents are -inf.
//   * cum is the forward kernel's: a sequential fp32 sum of
//     __fmul_rn(dt, a) in one thread per head (loading eight values at a
//     time, so the chain of adds does not wait on each load).

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 4 row groups x 2 column halves
constexpr int T = 64;         // s and q tile rows; P padded to 64
constexpr int LDX = T + 4;    // pitch of the x, dy, M^T and dCB^T tiles
constexpr int MAX_P = 64;
constexpr int MAX_N = 256;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use
constexpr int FW = 32;  // ssd_bwd_fin: the columns of N a dB or dC block owns

constexpr int HB = 2;  // heads a main block

// the dy tiles are split into tf32 hi / lo planes once a step where shared
// memory holds the second plane (not at N = 256)
template <int NP>
__host__ __device__ constexpr bool presplit() {
  return NP < 256;
}

struct Args {
  const float *x, *dt, *a, *bm, *cm, *dy, *dst, *dg;
  float *dx, *ddt, *da, *db, *dc;
  // scratch: dCB^T tiles per head block [BC][npair][nhb][T][T] and their
  // sums [BC][npair][T][T] (tile pairs (s tile, q tile >= s tile)); the
  // head blocks' state terms of dB [nhb][BC][Q][N]; row sums of T dt_s
  // per s tile [BC][H][nq][Q]; per s the ddt terms and the s-side dcum
  // terms [BC][H][Q]; per s tile the dcum term at Q - 1 [BC][H][nq]; da's
  // chunk partials [BC][H]
  float *dcb_part, *dcb, *dbs_part, *rowsum, *sdir, *scum, *slast, *da_part;
  int* count;  // arrival counters: [BC][nq] (main), [H] (da); zero at launch
  int BC, Q, H, P, N, nq, nhb, npair;
  int64_t xsb, xsq, xsh, dsb, dsq, bsb, bsq, csb, csq;
  bool vx, vb, vc, vy, vdst;  // rows 16-byte aligned (cp.async)
};

// the tile pair (s tile st, q tile qt >= st) of a chunk
__device__ __forceinline__ int pair_index(int st, int qt, int nq) {
  return st * nq - st * (st - 1) / 2 + (qt - st);
}

// the warps of one row group (64 threads) meet
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
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

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (ex2.approx: ~2^-22 relative error; 0 at -inf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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
    const float* d = dts + hl * Q;
    float* cu = cum + hl * Q;
    float run = 0.f;
    int s = 0;
    for (; s + 8 <= Q; s += 8) {  // eight loads in flight, then the adds
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = d[s + i];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        run = run + __fmul_rn(v[i], ah);
        cu[s + i] = run;
      }
    }
    for (; s < Q; ++s) {
      run = run + __fmul_rn(d[s], ah);
      cu[s] = run;
    }
  }
  __syncthreads();
}

// the row sums of T dt_s of one step (red: [4 row groups][T q]) to scratch
__device__ __forceinline__ void flush_rows(const Args& A, const float* red,
                                           int c, int h, int st, int qt) {
  if (threadIdx.x < T) {
    const int q = qt * T + threadIdx.x;
    if (q < A.Q)
      A.rowsum[((static_cast<int64_t>(c) * A.H + h) * A.nq + st) * A.Q + q] =
          ((red[threadIdx.x] + red[T + threadIdx.x]) +
           red[2 * T + threadIdx.x]) +
          red[3 * T + threadIdx.x];
  }
}

template <int NP>
constexpr size_t main_smem_floats(int Q) {
  return 2 * static_cast<size_t>(T) * (NP + 4) +
         static_cast<size_t>(HB + 3 + (presplit<NP>() ? 2 : 0)) * T * LDX +
         8 * T + 2 * static_cast<size_t>(HB) * Q;
}

// NP: N padded to a multiple of 64
template <int NP>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_main(const Args A) {
  constexpr int LDB = NP + 4;  // B, C and dst tile pitch
  constexpr int NH = NP / 16;  // n8 tiles of a warp's half of n
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_block;
  const int Q = A.Q, P = A.P, N = A.N, nq = A.nq;
  float* const Bs = smem;               // [T][LDB] B of the s tile
  float* const Cs = Bs + T * LDB;       // [T][LDB] C of a q tile; dst
  float* const Xs = Cs + T * LDB;       // [HB][T][LDX] x of the s tile
  float* const Ys = Xs + HB * T * LDX;  // [2][T][LDX] dy of a step
  float* const Ms = Ys + 2 * T * LDX;   // [T][LDX] M^T of a step
  float* const red = Ms + T * LDX;      // [2][4][T] row-sum partials
  float* const cum = red + 8 * T;       // [HB][Q]
  float* const dts = cum + HB * Q;      // [HB][Q]
  // [2][T][LDX] the lo tf32 plane of each dy buffer (the hi plane
  // overwrites the buffer), where presplit
  uint32_t* const Yl = reinterpret_cast<uint32_t*>(dts + HB * Q);

  const int per_st = A.BC * A.nhb;
  const int st = blockIdx.x / per_st;  // s tile 0 (the most q tiles) first
  const int c = (blockIdx.x % per_st) / A.nhb;
  const int hb = blockIdx.x % A.nhb;
  const int h0 = hb * HB, nh = min(HB, A.H - h0);
  const int s0 = st * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, hf = warp >> 2;  // row group, column half
  const int g = lane >> 2, t = lane & 3;
  const int sl = 16 * rg + g;  // the lane's local s rows sl and sl + 8
  const int sA = s0 + sl, sB = sA + 8;
  const bool inA = sA < Q, inB = sB < Q;
  const int qc = 32 * hf;  // the warp's local q (or p) columns qc .. + 31

  const float* xc = A.x + c * A.xsb;
  const float* dyc = A.dy + static_cast<int64_t>(c) * Q * A.H * P;
  const int64_t dyld = static_cast<int64_t>(A.H) * P;

  load_tile<T, NP, LDB>(Bs, A.bm + c * A.bsb, s0, Q, N, A.bsq, A.vb);
  for (int hl = 0; hl < nh; ++hl)
    load_tile<T, T, LDX>(Xs + hl * T * LDX, xc + (h0 + hl) * A.xsh, s0, Q,
                         P, A.xsq, A.vx);
  cp_async_commit();
  load_tile<T, NP, LDB>(Cs, A.cm + c * A.csb, s0, Q, N, A.csq, A.vc);
  load_tile<T, T, LDX>(Ys, dyc + h0 * P, s0, Q, P, dyld, A.vy);
  cp_async_commit();
  block_cum(cum, dts, A, c, h0, nh);

  float dxa[HB][4][4];  // dx: 16 s rows x 32 p of each head
  float cols[HB][4];    // sum_q T and sum_{q>s} T of rows sA, sB (partial)
#pragma unroll
  for (int h = 0; h < HB; ++h) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[h][j][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) cols[h][e] = 0.f;
  }
  float cbt[4][4], dcbt[4][4];  // C.B^T and sum_h dM L dt: 16 s x 32 q

  // steps (q tile, head), as the forward's y blocks walk theirs
  int qt = st, hh = 0, pqt = -1, ph = 0, step = 0;
  for (; qt < nq; ++step) {
    int nqt = qt, nhh = hh + 1;  // the next step
    if (nhh == nh) {
      nhh = 0;
      ++nqt;
    }
    if (nqt < nq)
      load_tile<T, T, LDX>(Ys + ((step + 1) & 1) * T * LDX,
                           dyc + (h0 + nhh) * P, nqt * T, Q, P, dyld, A.vy);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (pqt >= 0)
      flush_rows(A, red + ((step - 1) & 1) * 4 * T, c, h0 + ph, st, pqt);
    float* const Y = Ys + (step & 1) * T * LDX;
    uint32_t* const YL = Yl + (step & 1) * T * LDX;
    if constexpr (presplit<NP>()) {  // split dy once for the 8 warps
      for (int e = threadIdx.x; e < T * T / 4; e += THREADS) {
        const int off = (e / (T / 4)) * LDX + (e % (T / 4)) * 4;
        float4 v = *reinterpret_cast<float4*>(Y + off);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(Y + off) = hi;
        *reinterpret_cast<uint4*>(YL + off) = lo;
      }
      __syncthreads();
    }
    uint32_t ah[4], al[4];
    if (hh == 0) {  // C.B^T of (s tile, q tile), once for the block's heads
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cbt[j][e] = dcbt[j][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < NP; k0 += 8) {
        const int k = k0 + 2 * t;
        const float2 b0 = ld2(Bs + sl * LDB + k);
        const float2 b1 = ld2(Bs + (sl + 8) * LDB + k);
        split_a(b0.x, b1.x, b0.y, b1.y, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 cv = ld2(Cs + (qc + 8 * j + g) * LDB + k);
          mma_3xtf32(cbt[j], ah, al, cv.x, cv.y);
        }
      }
      __syncthreads();  // every warp is done with Cs
      if (qt + 1 < nq)
        load_tile<T, NP, LDB>(Cs, A.cm + c * A.csb, (qt + 1) * T, Q, N,
                              A.csq, A.vc);
      cp_async_commit();
    }
    float* const rd = red + (step & 1) * 4 * T + rg * T;
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      if (h != hh) continue;
      const float* X = Xs + h * T * LDX;
      // dM^T[s][q] = sum_p x[s][p] dy[q][p]
      float dmt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dmt[j][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < T; k0 += 8) {
        const int k = k0 + 2 * t;
        const float2 x0 = ld2(X + sl * LDX + k);
        const float2 x1 = ld2(X + (sl + 8) * LDX + k);
        split_a(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = (qc + 8 * j + g) * LDX + k;
          if constexpr (presplit<NP>()) {
            const uint2 bh = *reinterpret_cast<const uint2*>(Y + off);
            const uint2 bl = *reinterpret_cast<const uint2*>(YL + off);
            mma_3xtf32(dmt[j], ah, al, bh.x, bh.y, bl.x, bl.y);
          } else {
            const float2 yv = ld2(Y + off);
            mma_3xtf32(dmt[j], ah, al, yv.x, yv.y);
          }
        }
      }
      // M^T, T and dM L dt of the lane's elements; select the exponent,
      // never multiply by the mask
      const float* cu = cum + h * Q;
      const float* dh = dts + h * Q;
      const float cs[2] = {inA ? cu[sA] : 0.f, inB ? cu[sB] : 0.f};
      const float ds[2] = {inA ? dh[sA] : 0.f, inB ? dh[sB] : 0.f};
      const int sr[2] = {sA, sB};
      const bool sok[2] = {inA, inB};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float rp[2] = {0.f, 0.f};  // sum over the lane's rows of T dt_s
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mv[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int e = 2 * rr + e2;
            const int q = qt * T + qc + 8 * j + 2 * t + e2;
            const bool qin = q < Q;
            const float cq = qin ? cu[q] : 0.f;
            const int s = sr[rr];
            const float l = exp2_approx(
                qin && sok[rr] && s <= q ? (cq - cs[rr]) * LOG2E : -INFINITY);
            const float ldt = l * ds[rr];
            const float tv = dmt[j][e] * cbt[j][e] * l;
            mv[e2] = cbt[j][e] * ldt;
            cols[h][rr] += tv;
            if (s < q) {  // off the diagonal
              cols[h][2 + rr] += tv;
              rp[e2] += tv * ds[rr];
            }
            dcbt[j][e] += dmt[j][e] * ldt;
          }
          *reinterpret_cast<float2*>(Ms + (sl + 8 * rr) * LDX + qc + 8 * j +
                                     2 * t) = make_float2(mv[0], mv[1]);
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float v = rp[e2];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) rd[qc + 8 * j + 2 * t + e2] = v;
        }
      }
      pair_sync(1 + rg);  // M^T of the row group's 16 rows is written
      // dx[s][p] += sum_q M^T[s][q] dy[q][p], p in the warp's half
#pragma unroll
      for (int k0 = 0; k0 < T; k0 += 8) {
        const int k = k0 + 2 * t;
        const float2 m0 = ld2(Ms + sl * LDX + k);
        const float2 m1 = ld2(Ms + (sl + 8) * LDX + k);
        split_a(m0.x, m1.x, m0.y, m1.y, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = qc + 8 * j + g;
          if constexpr (presplit<NP>()) {
            const uint32_t* yh = reinterpret_cast<const uint32_t*>(Y);
            mma_3xtf32(dxa[h][j], ah, al, yh[k * LDX + p],
                       yh[(k + 1) * LDX + p], YL[k * LDX + p],
                       YL[(k + 1) * LDX + p]);
          } else {
            mma_3xtf32(dxa[h][j], ah, al, Y[k * LDX + p],
                       Y[(k + 1) * LDX + p]);
          }
        }
      }
    }
    if (hh == nh - 1) {  // the q tile's last head: the block's dCB^T tile
      float* out = A.dcb_part +
                   ((static_cast<int64_t>(c) * A.npair +
                     pair_index(st, qt, nq)) * A.nhb + hb) * T * T;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(out + (sl + 8 * rr) * T + qc + 8 * j +
                                     2 * t) =
              make_float2(dcbt[j][2 * rr], dcbt[j][2 * rr + 1]);
    }
    __syncthreads();  // this step's dy, M^T and row sums are read
    pqt = qt;
    ph = hh;
    qt = nqt;
    hh = nhh;
  }
  flush_rows(A, red + ((step - 1) & 1) * 4 * T, c, h0 + ph, st, pqt);
  cp_async_wait<0>();
  __syncthreads();  // the step loop's reads are done

  // per head: E = B dst^T, dx += w E, dw, and the state term of dB,
  // (w x)^T dst summed over the block's heads in registers.  Both heads'
  // dst tiles load at once (the second into the free dy buffers, where
  // it fits), and their row sums are reduced in one round.
  constexpr bool BOTH = T * (NP + 4) <= 2 * T * LDX;
  float* const dsts[2] = {Cs, BOTH ? Ys : Cs};
  auto load_dst = [&](int h) {
    load_tile<T, NP, LDB>(dsts[h],
                          A.dst + (static_cast<int64_t>(c) * A.H + h0 + h) *
                                      P * N,
                          0, P, N, N, A.vdst);
  };
  load_dst(0);
  if (BOTH && nh > 1) load_dst(1);
  cp_async_commit();
  float* const part = Ms;  // [HB][6][T]: dw, sum_q T, sum_{q>s} T per half
  float dbs[NH][4];        // 16 s rows x NP / 2 n
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbs[j][e] = 0.f;
  const bool even = (P & 1) == 0;
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    if (h >= nh) continue;
    const int hg = h0 + h;
    if (!BOTH && h > 0) {
      __syncthreads();  // head 0's reads of Cs are done
      load_dst(h);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    const float* Ds = dsts[h];
    const float* X = Xs + h * T * LDX;
    const float* cu = cum + h * Q;
    const float* dh = dts + h * Q;
    const float last = cu[Q - 1];
    uint32_t ah[4], al[4];
    float ev[4][4];  // E[s][p], p in the warp's half
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ev[j][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < NP; k0 += 8) {
      const int k = k0 + 2 * t;
      const float2 b0 = ld2(Bs + sl * LDB + k);
      const float2 b1 = ld2(Bs + (sl + 8) * LDB + k);
      split_a(b0.x, b1.x, b0.y, b1.y, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dv = ld2(Ds + (qc + 8 * j + g) * LDB + k);
        mma_3xtf32(ev[j], ah, al, dv.x, dv.y);
      }
    }
    const float w[2] = {inA ? expf(last - cu[sA]) * dh[sA] : 0.f,
                        inB ? expf(last - cu[sB]) * dh[sB] : 0.f};
    float dw[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = qc + 8 * j + 2 * t;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int s = rr ? sB : sA;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int e = 2 * rr + e2;
          dw[rr] += X[(sl + 8 * rr) * LDX + p + e2] * ev[j][e];
          dxa[h][j][e] += w[rr] * ev[j][e];
        }
        if (s < Q && p < P)
          store2(A.dx + ((static_cast<int64_t>(c) * Q + s) * A.H + hg) * P +
                     p,
                 dxa[h][j][2 * rr], dxa[h][j][2 * rr + 1], P - p, even);
      }
    }
    // the state term of dB: sum_p (w_s x[s][p]) dst[p][n], n in the half
#pragma unroll
    for (int k0 = 0; k0 < T; k0 += 8) {
      const int k = k0 + 2 * t;
      const float2 x0 = ld2(X + sl * LDX + k);
      const float2 x1 = ld2(X + (sl + 8) * LDX + k);
      split_a(x0.x * w[0], x1.x * w[1], x0.y * w[0], x1.y * w[1], ah, al);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int n = hf * (NP / 2) + 8 * j + g;
        mma_3xtf32(dbs[j], ah, al, Ds[k * LDB + n], Ds[(k + 1) * LDB + n]);
      }
    }
    // dw and the column sums of T per row: over the lane quad here, over
    // the two column halves below
    float v[6] = {dw[0], dw[1], cols[h][0], cols[h][1], cols[h][2],
                  cols[h][3]};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        part[(h * 6 + 2 * i + hf) * T + sl] = v[2 * i];
        part[(h * 6 + 2 * i + hf) * T + sl + 8] = v[2 * i + 1];
      }
    }
  }
  __syncthreads();
  // per (head, s): the ddt terms and the s-side dcum terms; the s tile's
  // dcum term at Q - 1 (sum of dw w over s < Q - 1) by warp sums
  float* const lastp = red;  // [HB][2] the two warps' sums of a head
  if (threadIdx.x < HB * T) {
    const int h = threadIdx.x / T, l = threadIdx.x % T, s = s0 + l;
    float dww = 0.f;
    if (h < nh && s < Q) {
      const float* pp = part + h * 6 * T;
      const float* cu = cum + h * Q;
      const float* dh = dts + h * Q;
      const int64_t ch = static_cast<int64_t>(c) * A.H + h0 + h;
      const float dwv = pp[l] + pp[T + l];
      const float colt = pp[2 * T + l] + pp[3 * T + l];
      const float colto = pp[4 * T + l] + pp[5 * T + l];
      const float es = expf(cu[Q - 1] - cu[s]);
      A.sdir[ch * Q + s] = colt + dwv * es;
      dww = s < Q - 1 ? dwv * es * dh[s] : 0.f;  // s = Q - 1: exponent 0
      A.scum[ch * Q + s] = -dh[s] * colto - dww;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dww += __shfl_xor_sync(0xffffffffu, dww, o);
    if (lane == 0) lastp[warp] = dww;
  }
  __syncthreads();
  if (threadIdx.x < nh)
    A.slast[(static_cast<int64_t>(c) * A.H + h0 + threadIdx.x) * nq + st] =
        lastp[2 * threadIdx.x] + lastp[2 * threadIdx.x + 1];
  // the head block's state term of dB
  const bool n_even = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    const int n = hf * (NP / 2) + 8 * j + 2 * t;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = rr ? sB : sA;
      if (s < Q && n < N)
        store2(A.dbs_part +
                   ((static_cast<int64_t>(hb) * A.BC + c) * Q + s) * N + n,
               dbs[j][2 * rr], dbs[j][2 * rr + 1], N - n, n_even);
    }
  }

  // the last head block of (chunk, s tile) to finish sums the dCB^T tiles
  // of the s tile's pairs over the head blocks, in head-block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(A.count + c * nq + st, 1) == A.nhb - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  constexpr int TT4 = T * T / 4;
  for (int qt2 = st; qt2 < nq; ++qt2) {
    const int64_t pr =
        static_cast<int64_t>(c) * A.npair + pair_index(st, qt2, nq);
    const float4* src =
        reinterpret_cast<const float4*>(A.dcb_part + pr * A.nhb * T * T);
    float4* dst = reinterpret_cast<float4*>(A.dcb + pr * T * T);
    for (int e = threadIdx.x; e < TT4; e += THREADS) {
      float4 s = __ldcg(src + e);
#pragma unroll 4
      for (int k = 1; k < A.nhb; ++k) {
        const float4 u = __ldcg(src + k * TT4 + e);
        s.x += u.x;
        s.y += u.y;
        s.z += u.z;
        s.w += u.w;
      }
      dst[e] = s;
    }
  }
}

template <int NP>
constexpr size_t fin_smem_floats(int Q) {
  const size_t tiles = static_cast<size_t>(T) * (LDX + FW + 4);
  const size_t dt = 3 * static_cast<size_t>(Q);
  return tiles > dt ? tiles : dt;
}

// per (chunk, s tile, FW columns of N): dB; per (chunk, q tile, FW
// columns): dC; per (chunk, head): dcum, ddt and da.  The column split
// spreads the reads of dB's head-block partials over more blocks.
template <int NP>
__global__ void __launch_bounds__(THREADS) ssd_bwd_fin(const Args A) {
  constexpr int LDW = FW + 4;  // the C / B column slice's pitch
  constexpr int NCH = NP / FW;  // column slices
  extern __shared__ __align__(16) float smem[];
  const int Q = A.Q, N = A.N, nq = A.nq;
  const int nbc = A.BC * nq * NCH;
  int b = blockIdx.x;
  if (b < 2 * nbc) {
    // dB rows of s tile `tile` (the most q tiles first), then dC rows of
    // q tile `tile` (the most s tiles first)
    const bool is_db = b < nbc;
    if (!is_db) b -= nbc;
    const int tile = is_db ? b / (A.BC * NCH) : nq - 1 - b / (A.BC * NCH);
    const int c = b % (A.BC * NCH) / NCH;
    const int n0 = b % NCH * FW;  // the block's first column
    if (n0 >= N) return;
    float* const Ds = smem;           // [T][LDX] dCB^T of a pair (s, q)
    float* const Ws = Ds + T * LDX;   // [T][LDW] C of the q tile / B of s
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rg = warp & 3, hf = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int rl = 16 * rg + g;  // the lane's local output rows rl, rl + 8
    float acc[2][4] = {};  // 16 rows x 16 columns (half hf of the slice)
    const int lo = is_db ? tile : 0, hi = is_db ? nq - 1 : tile;
    for (int o = lo; o <= hi; ++o) {
      const int st = is_db ? tile : o, qt = is_db ? o : tile;
      __syncthreads();  // the previous pair's reads are done
      load_tile<T, T, LDX>(
          Ds, A.dcb + (static_cast<int64_t>(c) * A.npair +
                       pair_index(st, qt, nq)) * T * T,
          0, T, T, T, true);
      if (is_db)
        load_tile<T, FW, LDW>(Ws, A.cm + c * A.csb + n0, qt * T, Q, N - n0,
                              A.csq, A.vc);
      else
        load_tile<T, FW, LDW>(Ws, A.bm + c * A.bsb + n0, st * T, Q, N - n0,
                              A.bsq, A.vb);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < T; k0 += 8) {
        const int k = k0 + 2 * t;
        uint32_t ah[4], al[4];
        if (is_db) {  // dB[s][n] = sum_q dCB^T[s][q] C[q][n]
          const float2 a0 = ld2(Ds + rl * LDX + k);
          const float2 a1 = ld2(Ds + (rl + 8) * LDX + k);
          split_a(a0.x, a1.x, a0.y, a1.y, ah, al);
        } else {  // dC[q][n] = sum_s dCB^T[s][q] B[s][n]
          split_a(Ds[k * LDX + rl], Ds[k * LDX + rl + 8],
                  Ds[(k + 1) * LDX + rl], Ds[(k + 1) * LDX + rl + 8], ah,
                  al);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = hf * 16 + 8 * j + g;
          mma_3xtf32(acc[j], ah, al, Ws[k * LDW + n], Ws[(k + 1) * LDW + n]);
        }
      }
    }
    const bool n_even = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + hf * 16 + 8 * j + 2 * t;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = tile * T + rl + 8 * rr;
        if (row >= Q || n >= N) continue;
        float v0 = acc[j][2 * rr], v1 = acc[j][2 * rr + 1];
        if (is_db) {  // plus the head blocks' state terms, in order
          for (int k = 0; k < A.nhb; ++k) {
            const float* p = A.dbs_part +
                             ((static_cast<int64_t>(k) * A.BC + c) * Q + row) *
                                 N + n;
            v0 += p[0];
            if (n + 1 < N) v1 += p[1];
          }
        }
        store2((is_db ? A.db : A.dc) + (static_cast<int64_t>(c) * Q + row) *
                                           N + n,
               v0, v1, N - n, n_even);
      }
    }
    return;
  }

  // per (chunk, head): dcum, its reverse cumsum, ddt and da's partial
  b -= 2 * nbc;
  float* const dts = smem;
  float* const cum = dts + Q;
  float* const dcum = cum + Q;
  const int c = b / A.H, h = b % A.H;
  const int64_t ch = static_cast<int64_t>(c) * A.H + h;
  block_cum(cum, dts, A, c, h, 1);
  for (int q = threadIdx.x; q < Q; q += THREADS) {
    float v = A.scum[ch * Q + q];
    for (int st = 0; st <= q / T; ++st)  // the s tiles that reach row q
      v += A.rowsum[(ch * nq + st) * Q + q];
    dcum[q] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
    for (int st = 0; st < nq; ++st) v += A.slast[ch * nq + st];
    dcum[Q - 1] += v + A.dg[ch] * expf(cum[Q - 1]);
    // cum = cumsum(dt a): d loss / d (dt a)_s is the reverse cumsum
    float run = 0.f, da = 0.f;
    int s = Q;
    for (; s >= 8; s -= 8) {  // eight of each load in flight, then the adds
      float dc[8], d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dc[i] = dcum[s - 1 - i];
        d[i] = dts[s - 1 - i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        run += dc[i];
        dcum[s - 1 - i] = run;
        da += run * d[i];
      }
    }
    for (; s > 0; --s) {
      run += dcum[s - 1];
      dcum[s - 1] = run;
      da += run * dts[s - 1];
    }
    A.da_part[ch] = da;
  }
  __syncthreads();
  const float ah = A.a[h];
  for (int s = threadIdx.x; s < Q; s += THREADS)
    A.ddt[(static_cast<int64_t>(c) * Q + s) * A.H + h] =
        A.sdir[ch * Q + s] + ah * dcum[s];
  // the head's last chunk to finish sums da over the chunks, in order
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(A.count + A.BC * nq + h, 1) == A.BC - 1) {
      __threadfence();
      float v = 0.f;
      for (int cc = 0; cc < A.BC; ++cc)
        v += __ldcg(A.da_part + static_cast<int64_t>(cc) * A.H + h);
      A.da[h] = v;
    }
  }
}

struct Sizes {
  int64_t nq, nhb, npair, dcb_part, dcb, dbs, rowsum, per_s, slast, da,
      counts;
};

int padded_n(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

Sizes sizes(int BC, int Q, int H, int N) {
  Sizes z;
  z.nq = (Q + T - 1) / T;
  z.nhb = (H + HB - 1) / HB;
  z.npair = z.nq * (z.nq + 1) / 2;
  z.dcb = static_cast<int64_t>(BC) * z.npair * T * T;
  z.dcb_part = z.dcb * z.nhb;
  z.dbs = z.nhb * BC * static_cast<int64_t>(Q) * N;
  z.rowsum = static_cast<int64_t>(BC) * H * z.nq * Q;
  z.per_s = static_cast<int64_t>(BC) * H * Q;
  z.slast = static_cast<int64_t>(BC) * H * z.nq;
  z.da = static_cast<int64_t>(BC) * H;
  z.counts = BC * z.nq + H;
  return z;
}

template <int NP>
int launch(const Args& A, cudaStream_t s) {
  const size_t sm_main = sizeof(float) * main_smem_floats<NP>(A.Q);
  const size_t sm_fin = sizeof(float) * fin_smem_floats<NP>(A.Q);
  if (sm_main > SMEM_MAX || sm_fin > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t g_main = static_cast<int64_t>(A.nq) * A.BC * A.nhb;
  const int64_t g_fin = 2 * static_cast<int64_t>(A.BC) * A.nq * (NP / FW) +
                        static_cast<int64_t>(A.BC) * A.H;
  if (g_main > 0x7fffffff || g_fin > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_main<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm_main));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_fin<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sm_fin));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_main<NP><<<static_cast<unsigned>(g_main), THREADS, sm_main, s>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_fin<NP><<<static_cast<unsigned>(g_fin), THREADS, sm_fin, s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = fp32 elements of the scratch buffer, out[1] = int32 elements
// of the counter buffer (zero at launch).
void ssd_intra_chunk_bwd_sizes(int BC, int Q, int H, int N, int64_t* out) {
  const Sizes z = sizes(BC, Q, H, N);
  out[0] = z.dcb_part + z.dcb + z.dbs + z.rowsum + 2 * z.per_s + z.slast +
           z.da;
  out[1] = z.counts;
}

// Inputs as ssd_intra_chunk_launch takes them (x [BC, Q, H, P], dt
// [BC, Q, H], B and C [BC, Q, N] by their strides, unit stride on the last
// dim; a [H] contiguous); dy [BC, Q, H, P], dst [BC, H, P, N] and dg
// [BC, H] contiguous.  Writes contiguous dx [BC, Q, H, P], ddt [BC, Q, H],
// da [H], db and dc [BC, Q, N].  scratch and count hold the counts of
// floats and ints that ssd_intra_chunk_bwd_sizes gives; count must be zero.
// Returns the first CUDA error of the two launches (0 = launched).
int ssd_intra_chunk_bwd_launch(
    const float* x, const float* dt, const float* a, const float* bm,
    const float* cm, const float* dy, const float* dst, const float* dg,
    float* dx, float* ddt, float* da, float* db, float* dc, float* scratch,
    int* count, int BC, int Q, int H, int P, int N, int64_t xsb,
    int64_t xsq, int64_t xsh, int64_t dsb, int64_t dsq, int64_t bsb,
    int64_t bsq, int64_t csb, int64_t csq, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || P > MAX_P || N <= 0 ||
      N > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sizes z = sizes(BC, Q, H, N);
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Args A{};
  A.x = x;
  A.dt = dt;
  A.a = a;
  A.bm = bm;
  A.cm = cm;
  A.dy = dy;
  A.dst = dst;
  A.dg = dg;
  A.dx = dx;
  A.ddt = ddt;
  A.da = da;
  A.db = db;
  A.dc = dc;
  A.dcb_part = scratch;
  A.dcb = A.dcb_part + z.dcb_part;
  A.dbs_part = A.dcb + z.dcb;
  A.rowsum = A.dbs_part + z.dbs;
  A.sdir = A.rowsum + z.rowsum;
  A.scum = A.sdir + z.per_s;
  A.slast = A.scum + z.per_s;
  A.da_part = A.slast + z.slast;
  A.count = count;
  A.BC = BC;
  A.Q = Q;
  A.H = H;
  A.P = P;
  A.N = N;
  A.nq = static_cast<int>(z.nq);
  A.nhb = static_cast<int>(z.nhb);
  A.npair = static_cast<int>(z.npair);
  A.xsb = xsb;
  A.xsq = xsq;
  A.xsh = xsh;
  A.dsb = dsb;
  A.dsq = dsq;
  A.bsb = bsb;
  A.bsq = bsq;
  A.csb = csb;
  A.csq = csq;
  A.vx = al16(x) && xsb % 4 == 0 && xsq % 4 == 0 && xsh % 4 == 0 &&
         P % 4 == 0;
  A.vb = al16(bm) && bsb % 4 == 0 && bsq % 4 == 0 && N % 4 == 0;
  A.vc = al16(cm) && csb % 4 == 0 && csq % 4 == 0 && N % 4 == 0;
  A.vy = al16(dy) && P % 4 == 0;
  A.vdst = al16(dst) && N % 4 == 0;
  if (!al16(scratch)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_n(N)) {
    case 64:
      return launch<64>(A, s);
    case 128:
      return launch<128>(A, s);
    default:
      return launch<256>(A, s);
  }
}

}  // extern "C"
