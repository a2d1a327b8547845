// Building blocks of the fused HSTU block's wgmma kernels for Hopper, sm_90a:
// the attention-plus-post forward (attn_ffn_wgmma_kernel, csrc/
// fused_block.cu), the gate/FFN backward (gate_ffn_bwd_wgmma_kernel) and the
// weight-gradient products over tokens (wgrad_wgmma_kernel, both in csrc/
// fused_block_bwd.cu).
//
// Conventions (those of csrc/sm90_mma.cuh): one warpgroup of 128 threads
// owns 64 token rows; a [64 x N] f32 value lives in wgmma's accumulator
// layout (acc_row, acc_col), so that a row's values sit in the four threads
// of a quad and its LayerNorm statistics are two __shfl_xor each; a bf16
// product operand on the A side is that layout's register fragment (frag),
// rounded to nearest, so that T(g), T(LN3(y)), T(f), T(dout), T(dx13) and
// T(dy) never pass through shared memory. The model width D (a multiple of
// 16, at most 128) is padded to DW = 32, 64 or 128 columns: padded columns
// of every value are 0 and padded rows and columns of every weight tile are
// loaded as zeros, so they add nothing to any product.
//
// The weights are wgmma B operands in swizzled shared-memory tiles (Tile<>),
// streamed by chunk through a two-stage cp.async ring: one tile serves as an
// MN-major operand (its rows the K index: x1 = h2 . W13) and as a K-major one
// (its rows the N index: dh2 = dx13 . W13^T), so no weight is transposed.
#pragma once

#include "fused_block_common.cuh"
#include "sm90_mma.cuh"

namespace fb90 {

using fbk::bf16;
using sm90::acc_col;
using sm90::acc_row;
using sm90::Tile;

constexpr int kWg = sm90::kWgThreads;  // one warpgroup
constexpr int kRows = sm90::kRows;     // token rows of a tile

// FFN chunk (columns of F) of the forward: 64, or 32 at DW = 128, where the
// chunk's x1 and x3 accumulators beside y and T(LN3(y)) would spill
template <int DW>
struct FwdChunk {
  static constexpr int kFC = DW >= 128 ? 32 : 64;
};

// The backward's FFN chunk is 32 columns (x1, x3 and df beside dh2, T(h2)
// and T(dout) spill at 64 from DW = 64 on); a ring step carries two chunks.
constexpr int kBwdFC = 32;
constexpr int kBwdCPS = 2;

// The padded width of a model of width D, 0 past 128.
inline int post_width(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

__host__ __device__ constexpr size_t round1024(size_t n) {
  return (n + 1023) & ~size_t(1023);
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// ---------------------------------------------------------------------------
// loads
// ---------------------------------------------------------------------------

// The rows x cols block at src (row stride ld elements; cols, ld and the
// column offset of src multiples of 8, src 16-byte aligned) into the swizzled
// tile t of rows_pad x TW elements: cp.async for the 16-byte chunks inside
// the block, zeros for the rest, so that a tile's padding is 0 whatever the
// stage held before. Every thread of the warpgroup takes part.
template <int TW>
__device__ __forceinline__ void load_mat(bf16* t, int rows_pad,
                                         const bf16* src, size_t ld,
                                         int rows, int cols) {
  constexpr int kCh = TW / 8;  // chunks per tile row
  unsigned char* tb = reinterpret_cast<unsigned char*>(t);
  const int total = rows_pad * kCh;
  for (int i = threadIdx.x; i < total; i += kWg) {
    const int r = i / kCh, c = (i % kCh) * 8;
    unsigned char* dst = tb + Tile<TW>::offset(r, c, rows_pad);
    if (r < rows && c < cols)
      sm90::cp_async16(dst, src + (size_t)r * ld + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// values in the accumulator layout
// ---------------------------------------------------------------------------

// This thread's element i of a [64 x N] value: row acc_row(i), column
// acc_col(i); elements i and i + 1 (i even) are columns c and c + 1 of one
// row, so pairs load and store as one 4- or 8-byte access.

// The A operand (64 x 16, bf16) of columns 16 kk .. 16 kk + 15 of a 64 x N
// value held as N / 2 floats; kk a compile-time constant after unrolling.
template <int NF>
__device__ __forceinline__ void frag(const float (&p)[NF], int kk,
                                     uint32_t (&a)[4]) {
  a[0] = sm90::pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = sm90::pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = sm90::pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = sm90::pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
}

// Every A fragment of a 64 x N value.
template <int NF>
__device__ __forceinline__ void frags(const float (&p)[NF],
                                      uint32_t (&a)[NF / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NF / 8; ++kk) frag(p, kk, a[kk]);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// Pair i of a bf16 [64 x ld] row block (columns c, c + 1), 0 past D.
__device__ __forceinline__ float2 ld_bf16x2(const bf16* rows, size_t ld,
                                            int i, int D) {
  const int c = acc_col(i);
  if (c >= D) return make_float2(0.0f, 0.0f);
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(
      rows + (size_t)acc_row(i) * ld + c));
}

__device__ __forceinline__ float2 ld_f32x2(const float* rows, size_t ld,
                                           int i, int D) {
  const int c = acc_col(i);
  if (c >= D) return make_float2(0.0f, 0.0f);
  return *reinterpret_cast<const float2*>(rows + (size_t)acc_row(i) * ld +
                                          c);
}

// The pair (v[i], v[i + 1]) of the parameter vector at columns c, c + 1.
__device__ __forceinline__ float2 ld_vec2(const float* v, int i, int D) {
  const int c = acc_col(i);
  if (c >= D) return make_float2(0.0f, 0.0f);
  return *reinterpret_cast<const float2*>(v + c);
}

template <int NF>
__device__ __forceinline__ void st_bf16(bf16* rows, size_t ld,
                                        const float (&v)[NF], int D) {
#pragma unroll
  for (int i = 0; i < NF; i += 2) {
    const int c = acc_col(i);
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(rows + (size_t)acc_row(i) * ld + c) =
          __floats2bfloat162_rn(v[i], v[i + 1]);
  }
}

template <int NF>
__device__ __forceinline__ void st_f32(float* rows, size_t ld,
                                       const float (&v)[NF], int D) {
#pragma unroll
  for (int i = 0; i < NF; i += 2) {
    const int c = acc_col(i);
    if (c < D)
      *reinterpret_cast<float2*>(rows + (size_t)acc_row(i) * ld + c) =
          make_float2(v[i], v[i + 1]);
  }
}

// A value that stays with its thread between two steps, kept in shared
// memory at [element][thread] (conflict-free): the backward's u, y and T(h1)
// fragments.
template <typename T, int NF>
__device__ __forceinline__ void keep(T* s, const T (&v)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) s[i * kWg + threadIdx.x] = v[i];
}

template <typename T, int NF>
__device__ __forceinline__ void unkeep(const T* s, T (&v)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) v[i] = s[i * kWg + threadIdx.x];
}

// The A fragments of a bf16 [64 x ld] row block (columns past D 0): a
// product operand straight from memory.
template <int KS>
__device__ __forceinline__ void frags_of(const bf16* rows, size_t ld, int D,
                                         uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = 8 * kk + 2 * v, c = acc_col(i);
      a[kk][v] = c < D ? *reinterpret_cast<const uint32_t*>(
                             rows + (size_t)acc_row(i) * ld + c)
                       : 0u;
    }
}

// Mean and 1/sqrt(var + eps) of this thread's two rows (h = 0: acc_row(0),
// h = 1: acc_row(0) + 8) over the first D columns: the LayerNorm statistics
// of csrc/fused_block_common.cuh's row_stats, two-pass, eps 1e-8.
template <int NF>
__device__ __forceinline__ void row_stats(const float (&v)[NF], int D,
                                          float (&mu)[2], float (&rs)[2]) {
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NF; ++i)
    if (acc_col(i) < D) s[(i >> 1) & 1] += v[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) mu[h] = sm90::quad_sum(s[h]) / D;
  float q[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const float t = v[i] - mu[(i >> 1) & 1];
    if (acc_col(i) < D) q[(i >> 1) & 1] += t * t;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) rs[h] = rsqrtf(sm90::quad_sum(q[h]) / D +
                                             fbk::kEps);
}

// Per row, the means over D columns of a(i) and a(i) * b(i): the two means
// of a LayerNorm backward (a = gradient * gamma, b = xhat).
template <int NF, typename A, typename B>
__device__ __forceinline__ void row_means(A a, B b, int D, float (&m1)[2],
                                          float (&m2)[2]) {
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    if (acc_col(i) < D) {
      const float t = a(i);
      s1[(i >> 1) & 1] += t;
      s2[(i >> 1) & 1] += t * b(i);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m1[h] = sm90::quad_sum(s1[h]) / D;
    m2[h] = sm90::quad_sum(s2[h]) / D;
  }
}

// One column sum over the tile's 64 rows of v(i), this warp's share: the
// thread's two rows, then the 8 threads of the warp that hold the same
// columns (in a fixed order), written to w[warp * DW + column]. The block
// adds the four warps' shares in order afterwards (fold_cols).
template <int DW, typename V>
__device__ __forceinline__ void col_part(float* w, V v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < DW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v(4 * j + e) + v(4 * j + 2 + e);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) w[warp * DW + 8 * j + 2 * lane + e] = s;
    }
  }
}

// sums[k][c] += the four warps' shares of column sum k (k < n), in order;
// after a barrier that follows the col_part calls.
template <int DW>
__device__ __forceinline__ void fold_cols(float* sums, const float* w,
                                          int n) {
  for (int i = threadIdx.x; i < n * DW; i += kWg) {
    const int k = i / DW, c = i - k * DW;
    const float* wk = w + (size_t)k * 4 * DW;
    sums[i] += ((wk[c] + wk[DW + c]) + wk[2 * DW + c]) + wk[3 * DW + c];
  }
}

// silu(v) = v sig(v) and its derivative sig (1 + v (1 - sig)), the sigmoid
// by the special-function unit (ex2.approx, rcp.approx)
__device__ __forceinline__ float fast_sigmoid(float v) {
  float y;
  const float e = sm90::exp2_approx(-v * sm90::kLog2e);
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(1.0f + e));
  return y;
}

__device__ __forceinline__ float fast_silu(float v) {
  return v * fast_sigmoid(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// chains of products (one warpgroup; the caller fences, commits and waits)
// ---------------------------------------------------------------------------

// acc[64 x N] (= or +=) sum over kk < KS of a[kk] . B_kk, B an N-wide tile:
// MN-major (TB 1, desc(kk) its k16 slice kk of rows) or K-major (TB 0).
template <int N, int TB, int KS, typename Desc>
__device__ __forceinline__ void chain(float (&acc)[N / 2],
                                      const uint32_t (&a)[KS][4], Desc desc,
                                      bool add) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    sm90::mma_rs<N, TB>(acc, a[kk], desc(kk), (add || kk > 0) ? 1 : 0);
}

// The completion of every product issued since the last commit.
template <int NF>
__device__ __forceinline__ void finish(float (&acc)[NF]) {
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::reg_fence(acc);
}

}  // namespace fb90
