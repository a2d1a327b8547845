// Building blocks of the fused HSTU block's wgmma kernels for Hopper, sm_90a:
// LN1 and the projection (proj_wgmma_kernel) and the attention-plus-post
// forward (attn_ffn_wgmma_kernel, both in csrc/fused_block.cu), the
// gate/FFN backward (gate_ffn_bwd_wgmma_kernel), the projection backward
// (proj_bwd_wgmma_kernel) and the weight-gradient products over tokens
// (wgrad_wgmma_kernel, all three in csrc/fused_block_bwd.cu); and the
// attention loop that attn_ffn_wgmma_kernel, the ring's
// pair_fwd_wgmma_kernel (csrc/ring_pair.cu) and the standalone HSTU
// attention's hstu_fwd_wgmma_kernel (csrc/hstu_attention.cu) all run
// (attn_issue, attn_step).
//
// Conventions (those of csrc/sm90_mma.cuh): one warpgroup of 128 threads
// owns 64 token rows; a [64 x N] f32 value lives in wgmma's accumulator
// layout (acc_row, acc_col), so that a row's values sit in the four threads
// of a quad and its LayerNorm statistics are two __shfl_xor each; a bf16
// product operand on the A side is that layout's register fragment (frag),
// rounded to nearest, so that T(h1), T(g), T(LN3(y)), T(f), T(dout),
// T(dx13), T(dy) and T(duvqk) never pass through shared memory. The model width D (a multiple of
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

// Whether the attention loop (attn_issue, attn_step) takes heads of hd = D /
// H columns: head slices in whole 16-byte chunks, at most 128 wide.
inline bool attn_heads(int D, int H) {
  const int hd = D / H;
  return hd % 8 == 0 && sm90::wgmma_width(hd) != 0;
}

__host__ __device__ constexpr size_t round1024(size_t n) {
  return (n + 1023) & ~size_t(1023);
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// A persistent kernel of one warpgroup a block over ntiles tiles: as many
// blocks as share the card's SMs at this shared memory (at most ntiles),
// each striding over the tiles. Returns a cudaError_t code.
template <typename K, typename A>
inline int launch_persistent(K kernel, size_t smem, int ntiles,
                             cudaStream_t stream, const A& args) {
  if (smem > fbk::kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWg,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const int fit = (per_sm > 1 ? per_sm : 1) * sms;
  kernel<<<ntiles < fit ? ntiles : fit, kWg, smem, stream>>>(args);
  return (int)cudaGetLastError();
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

// Four consecutive columns a thread moves with one 8-byte (bf16) or 16-byte
// (f32) access. Element pairs p and p + 2 of a thread (p = 2 j + h, j even:
// the same row, column blocks j and j + 1) trade halves with the
// neighbouring lane of its quad (lane ^ 1): the even lane then holds four
// columns of block j from acc_col(2 p), the odd one four of block j + 1
// from acc_col(2 p + 4) - 2. A block pair lies wholly inside or outside D
// (D a multiple of 16).
__device__ __forceinline__ int quad_col(int p) {
  return (threadIdx.x & 1) ? acc_col(2 * p + 4) - 2 : acc_col(2 * p);
}

__device__ __forceinline__ float2 shfl1(float2 v) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, 1),
                     __shfl_xor_sync(0xffffffffu, v.y, 1));
}

__device__ __forceinline__ uint32_t shfl1(uint32_t v) {
  return __shfl_xor_sync(0xffffffffu, v, 1);
}

// the pairs (a: column block j, b: block j + 1) -> the four columns this
// lane stores, in order
template <typename U>
__device__ __forceinline__ void quad_out(U a, U b, U& lo, U& hi) {
  const bool odd = threadIdx.x & 1;
  const U got = shfl1(odd ? a : b);
  lo = odd ? got : a;
  hi = odd ? b : got;
}

// the four columns this lane loaded -> its pairs of blocks j and j + 1
template <typename U>
__device__ __forceinline__ void quad_in(U lo, U hi, U& a, U& b) {
  const bool odd = threadIdx.x & 1;
  const U got = shfl1(odd ? lo : hi);
  a = odd ? got : lo;
  b = odd ? hi : got;
}

// This thread's bf16 pairs of a [64 x ld] row block, raw (pair p holds
// elements 2 p and 2 p + 1; 0 past D), by 8-byte loads.
template <int NP>
__device__ __forceinline__ void ld_pairs(const bf16* rows, size_t ld, int D,
                                         uint32_t (&r)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; p += 4)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = quad_col(p + h);
      uint2 v = make_uint2(0u, 0u);
      if (c < D)
        v = *reinterpret_cast<const uint2*>(rows +
                                            (size_t)acc_row(2 * p + 2 * h) *
                                                ld + c);
      quad_in(v.x, v.y, r[p + h], r[p + h + 2]);
    }
}

// The same pairs stored (columns past D skipped), 8 bytes a thread.
template <int NP>
__device__ __forceinline__ void st_pairs(bf16* rows, size_t ld, int D,
                                         const uint32_t (&r)[NP]) {
#pragma unroll
  for (int p = 0; p < NP; p += 4)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 v;
      quad_out(r[p + h], r[p + h + 2], v.x, v.y);
      const int c = quad_col(p + h);
      if (c < D)
        *reinterpret_cast<uint2*>(rows + (size_t)acc_row(2 * p + 2 * h) * ld +
                                  c) = v;
    }
}

// A [64 x N] f32 value (NF = N / 2 elements a thread) stored rounded to
// bf16, 8 bytes a thread.
template <int NF>
__device__ __forceinline__ void st_bf16_q(bf16* rows, size_t ld, int D,
                                          const float (&v)[NF]) {
  uint32_t r[NF / 2];
#pragma unroll
  for (int p = 0; p < NF / 2; ++p) r[p] = sm90::pack_bf16(v[2 * p],
                                                          v[2 * p + 1]);
  st_pairs(rows, ld, D, r);
}

// A [64 x N] f32 value stored in f32, 16 bytes a thread.
template <int NF>
__device__ __forceinline__ void st_f32_q(float* rows, size_t ld, int D,
                                         const float (&v)[NF]) {
#pragma unroll
  for (int p = 0; p < NF / 2; p += 4)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 lo, hi;
      quad_out(make_float2(v[2 * p + 2 * h], v[2 * p + 2 * h + 1]),
               make_float2(v[2 * p + 2 * h + 4], v[2 * p + 2 * h + 5]), lo,
               hi);
      const int c = quad_col(p + h);
      if (c < D)
        *reinterpret_cast<float4*>(rows + (size_t)acc_row(2 * p + 2 * h) *
                                              ld + c) =
            make_float4(lo.x, lo.y, hi.x, hi.y);
    }
}

// This thread's elements of an f32 [64 x ld] row block (0 past D), by
// 16-byte loads.
template <int NF>
__device__ __forceinline__ void ld_f32_q(const float* rows, size_t ld, int D,
                                         float (&v)[NF]) {
#pragma unroll
  for (int p = 0; p < NF / 2; p += 4)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = quad_col(p + h);
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < D)
        w = *reinterpret_cast<const float4*>(rows +
                                             (size_t)acc_row(2 * p + 2 * h) *
                                                 ld + c);
      float2 a, b;
      quad_in(make_float2(w.x, w.y), make_float2(w.z, w.w), a, b);
      const int i = 2 * p + 2 * h;
      v[i] = a.x;
      v[i + 1] = a.y;
      v[i + 4] = b.x;
      v[i + 5] = b.y;
    }
}

// The same elements of a bf16 row block, widened to f32 (8-byte loads).
template <int NF>
__device__ __forceinline__ void ld_bf16_q(const bf16* rows, size_t ld, int D,
                                          float (&v)[NF]) {
  uint32_t r[NF / 2];
  ld_pairs(rows, ld, D, r);
#pragma unroll
  for (int p = 0; p < NF / 2; ++p) {
    const float2 e = unpack_bf16(r[p]);
    v[2 * p] = e.x;
    v[2 * p + 1] = e.y;
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

// ---------------------------------------------------------------------------
// the pre half: LN1 and the projection to u, v, q, k, in the accumulator
// layout (proj_wgmma_kernel, proj_bwd_wgmma_kernel and the recompute of
// gate_ffn_bwd_wgmma_kernel)
// ---------------------------------------------------------------------------

// LN1 of a tile from x's raw bf16 pairs (ld_pairs): T(h1)'s A fragments
// (0 past D), and the rows' mean and 1/sqrt(var + eps). ln points at LN1's
// gamma, then its beta (the [6, D] pack).
template <int DW>
__device__ __forceinline__ void ln1(const uint32_t (&xr)[DW / 4],
                                    const float* ln, int D,
                                    uint32_t (&h1a)[DW / 16][4],
                                    float (&mu)[2], float (&rs)[2]) {
  constexpr int NF = DW / 2;
  float v[NF];
#pragma unroll
  for (int p = 0; p < NF / 2; ++p) {
    const float2 e = unpack_bf16(xr[p]);
    v[2 * p] = e.x;
    v[2 * p + 1] = e.y;
  }
  row_stats(v, D, mu, rs);
#pragma unroll
  for (int i = 0; i < NF; i += 2) {
    const int hf = (i >> 1) & 1;
    const float2 gg = ld_vec2(ln, i, D), bb = ld_vec2(ln + D, i, D);
    v[i] = (v[i] - mu[hf]) * rs[hf] * gg.x + bb.x;
    v[i + 1] = (v[i + 1] - mu[hf]) * rs[hf] * gg.y + bb.y;
  }
  frags(v, h1a);
}

// Wuvqk's four DW x DW slices (u, v, q, k) in shared memory from base,
// step s of a kernel being slice s % 4 of its tile s / 4: at DW <= 64 all
// four held for the whole kernel (8 or 32 KB, loaded once), at DW = 128
// (32 KB a slice) streamed through the two-stage cp.async ring, one slice a
// step. Every thread of the warpgroup calls each member.
template <int DW>
struct WuvqkSlices {
  static constexpr bool kHeld = DW <= 64;
  static constexpr size_t kSlice = (size_t)DW * DW * 2;
  static constexpr size_t kBytes =
      (kHeld ? 4 : sm90::kStages) * kSlice;   // a multiple of 1024
  unsigned char* base;
  const bf16* w;   // Wuvqk [D, 4D]
  int D, steps;

  __device__ bf16* slot(int s) const {
    return reinterpret_cast<bf16*>(
        base + (kHeld ? s % 4 : s % sm90::kStages) * kSlice);
  }
  __device__ void issue(int s) const {   // the ring's load of step s
    if (s < steps) load_mat<DW>(slot(s), DW, w + (s % 4) * D, 4 * D, D, D);
    sm90::cp_async_commit();
  }
  // before the first step (a barrier where the slices are held)
  __device__ void start() const {
    if constexpr (kHeld) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        load_mat<DW>(slot(k), DW, w + k * D, 4 * D, D, D);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      sm90::fence_async_smem();
      __syncthreads();
    } else {
      issue(0);
    }
  }
  // step s's slice, ready to read (the ring: a barrier, the next load out)
  __device__ const bf16* acquire(int s) const {
    if constexpr (!kHeld) {
      issue(s + 1);
      sm90::cp_async_wait<1>();
      sm90::fence_async_smem();
      __syncthreads();
    }
    return slot(s);
  }
  // after the last read of step s's slice (the ring: a barrier before a
  // later issue reloads its stage)
  __device__ void release() const {
    if constexpr (!kHeld) __syncthreads();
  }
};

// pre = T(h1) W_k, W_k one DW x DW slice of Wuvqk in shared memory (an
// MN-major operand: its rows the K index), without the bias.
template <int DW>
__device__ __forceinline__ void proj_slice(float (&pre)[DW / 2],
                                           const uint32_t (&h1a)[DW / 16][4],
                                           const bf16* w) {
  sm90::wgmma_fence();
  chain<DW, 1>(pre, h1a, [&](int kk) { return Tile<DW>::desc_mn(w, DW, kk); },
               false);
  finish(pre);
}

// silu(pre + b) * mul on the first D columns, 0 past them: slice k's u,
// v / L, q hd^-1/2 or k (b the slice's bias).
template <int NF>
__device__ __forceinline__ void silu_bias(float (&pre)[NF], const float* b,
                                          int D, float mul) {
#pragma unroll
  for (int i = 0; i < NF; i += 2) {
    const float2 bb = ld_vec2(b, i, D);
    const bool in = acc_col(i) < D;
    pre[i] = in ? fast_silu(pre[i] + bb.x) * mul : 0.0f;
    pre[i + 1] = in ? fast_silu(pre[i + 1] + bb.y) * mul : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the attention loop: one 64-query tile against one head's key tiles, a
// step per key tile (attn_ffn_wgmma_kernel on one device and
// hstu_fwd_wgmma_kernel, at distance q - k; pair_fwd_wgmma_kernel on a
// ring's pair of shards, at q + off - k)
// ---------------------------------------------------------------------------

// A step's row data in its stage: the key tile's 64 valid flags (int), then
// from byte kBiasAt the biases of its 127 diagonals (diagonal e = r - c + 63,
// r the query row and c the key column in the tile).
constexpr int kBiasAt = 256;

// Issues (cp.async, uncommitted) the loads of one step: k and v, the
// rows x hd blocks of a head from the key tile's first row (row stride D),
// into the W-wide tiles kt and vt; the keys' valid flags; and the tile's
// biases rab_h[clamp(based + e - 63, 0, NB - 1)], based the distance of
// pair (0, 0). nk is the number of keys from the tile's first on: with
// kRagged (a shard whose length need not be a multiple of 64) the keys past
// nk load as zero rows with valid flag 0; without, the tile is whole (nk >=
// 64, and the single device's loop keeps its registers). Every thread of
// the warpgroup calls it.
template <int W, bool kRagged>
__device__ __forceinline__ void attn_issue(bf16* kt, bf16* vt,
                                           unsigned char* rows, const bf16* k,
                                           const bf16* v, const int* valid,
                                           const float* rab_h, int D, int hd,
                                           int nk, int based, int NB) {
  const int tid = threadIdx.x;
  const int nr = kRagged && nk < kRows ? nk : kRows;
  load_mat<W>(kt, kRows, k, D, nr, hd);
  load_mat<W>(vt, kRows, v, D, nr, hd);
  if (tid < kRows) {
    int* kv = reinterpret_cast<int*>(rows);
    if (!kRagged || tid < nr)
      sm90::cp_async4(kv + tid, valid + tid);
    else
      kv[tid] = 0;
  }
  if (tid < 2 * kRows - 1) {
    const int dist = based + tid - (kRows - 1);
    sm90::cp_async4(reinterpret_cast<float*>(rows + kBiasAt) + tid,
                    rab_h + min(max(dist, 0), NB - 1));
  }
}

// One step on a stage whose loads have landed (after the ring's wait and
// fence; the barrier inside makes every thread's copies visible): acc (64 x
// W, f32) += T(a) v_h, with S = q_h k_h^T (SS wgmma) into s and a =
// silu(s + bias) * a_mul where the pair's distance based + r - c is >= 0
// and its key valid, else 0, in registers; T(a) goes straight into the A
// fragments of the RS wgmma. a_mul is 1 for the fused block and the ring
// (their v is already scaled by 1/L: a literal 1.0f folds away) and 1/L for
// the standalone HSTU attention, which rounds a after the factor. A tile
// whose pairs are all visible (every key valid, every distance >= 0) takes
// the unmasked path. s is the caller's scratch; r0 and c0 are acc_row(0)
// and acc_col(0), which the caller computes once for its whole loop.
template <int W>
__device__ __forceinline__ void attn_step(float (&acc)[W / 2],
                                          float (&s)[32], const bf16* q,
                                          const bf16* kt, const bf16* vt,
                                          const unsigned char* rows,
                                          int based, int r0, int c0,
                                          float a_mul) {
  const int tid = threadIdx.x;
  const int* kv = reinterpret_cast<const int*>(rows);
  const float* rw = reinterpret_cast<const float*>(rows + kBiasAt);
  // every key of the tile valid? (each thread reads the flag it copied)
  const bool full = __syncthreads_and(tid >= kRows || kv[tid] != 0);
  sm90::wgmma_fence();
  sm90::scores<W>(s, q, kt);
  finish(s);
  auto act = [&](auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r0 + (((i >> 1) & 1) << 3);
      const int c = c0 + ((i >> 2) << 3) + (i & 1);
      const float a = fast_silu(s[i] + rw[r - c + kRows - 1]);
      const bool vis = !kMasked || (based + r - c >= 0 && kv[c] != 0);
      s[i] = vis ? a * a_mul : 0.0f;
    }
  };
  if (full && based >= kRows - 1)
    act(std::false_type{});
  else
    act(std::true_type{});
  uint32_t a[4][4];
  frags(s, a);
  sm90::wgmma_fence();
  sm90::accumulate<W>(acc, a, vt);
  finish(acc);
}

}  // namespace fb90
