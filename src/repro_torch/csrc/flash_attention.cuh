// Shared by csrc/flash_attention.cu (the forward) and
// csrc/flash_attention_bwd.cu (the backward), two sources so that they
// compile in parallel: the dtype and path codes, the masks' constants, the
// key range of a query tile, and the bf16 tiles' layout and loads.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace {

// dtype and path codes shared with kernels/flash_attention/ops.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kPathSimt = 0;
constexpr int kPathMma = 1;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The keys [*begin, *end) that a query tile of `rows` rows at positions p0
// .. p0 + rows - 1 may see (p0 = its first row + q_offset), begin rounded
// down to a `tile` boundary: the causal end is the last row's position,
// the window start the first row's less window - 1.  Empty (begin >= end)
// where every key lies past the causal end or before the window.
__device__ __forceinline__ void key_range(int p0, int rows, int Skv,
                                          int causal, int window, int tile,
                                          int* begin, int* end) {
  *end = causal ? min(Skv, p0 + rows) : Skv;
  *begin = window > 0 ? max(0, p0 - window + 1) / tile * tile : 0;
}

// threads of a block: the fp32 kernels' and the bf16 kernels' (four warps)
constexpr int THREADS = 128;
constexpr int MMA_THREADS = 128;

// Smem row pitch of a DP-wide tile: 16 bytes of padding make the rows'
// 16-byte segments fall in 8 distinct bank groups (DP / 8 + 1 is odd), so
// ldmatrix is conflict-free.
template <int DP>
__host__ __device__ constexpr int pitch() {
  return DP + 8;
}

// rows [r0, r0 + ROWS) of a [S, D] bf16 matrix (row stride ld) into a
// [ROWS, DP] smem tile, zero past S and past D.
template <int DP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int D, int64_t ld) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * CH; e += MMA_THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    bf16* d = dst + r * pitch<DP>() + c;
    const bool in_row = r0 + r < S;
    const bf16* g = src + static_cast<int64_t>(r0 + r) * ld + c;
    if (VEC) {
      const bool ok = in_row && c < D;
      cp_async16(d, ok ? g : src, ok);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x)
        d[x] = (in_row && c + x < D) ? g[x] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void store_pair_bf16(bf16* p, float x, float y,
                                                bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16(x);
    if (two) p[1] = __float2bfloat16(y);
  }
}

}  // namespace
