// Shared device helpers of the port's kernels (fused_block.cu,
// fused_block_bwd.cu, flash_attention.cu, hstu_attention.cu): conversions,
// SiLU, warp sums and maxima, block-wide products (WMMA bf16 tensor-core
// tiles, or FMA loops for the f32 check instance), LayerNorm row
// statistics, tile and head-slice loads and the dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

namespace fbk {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNC = 64;        // output-column chunk of the weight products
constexpr int kLdS = kNC + 4;  // f32 chunk tile leading dim
constexpr int kLdP = kNC + 8;  // compute-dtype chunk tile leading dim
constexpr float kEps = 1e-8f;
constexpr size_t kMaxSmem = 232448;  // H100 opt-in shared memory per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + __expf(-v));
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + __expf(-v));
}

// d silu(v) / dv = sig(v) * (1 + v * (1 - sig(v)))
__device__ __forceinline__ float dsilu(float v) {
  const float s = sigmoid(v);
  return s * (1.0f + v * (1.0f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// C[M x N] (f32, ldc) = (ACCUM ? C : 0) + A . B over K. A is row-major
// [M x K] (lda), or with A_T the transpose of a row-major [K x M] array; B is
// row-major [K x N] (ldb), or with B_T the transpose of a row-major [N x K]
// array. C may live in shared or global memory. FMA loops: any widths.
template <typename T, bool A_T, bool B_T, bool ACCUM>
__device__ void gemm_fma(const T* A, int lda, const T* B, int ldb, float* C,
                         int ldc, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i - m * N;
    float acc = 0.0f;
    for (int kk = 0; kk < K; ++kk) {
      const float a = to_f(A_T ? A[(size_t)kk * lda + m]
                               : A[(size_t)m * lda + kk]);
      const float b = to_f(B_T ? B[(size_t)n * ldb + kk]
                               : B[(size_t)kk * ldb + n]);
      acc += a * b;
    }
    float* c = C + (size_t)m * ldc + n;
    *c = ACCUM ? *c + acc : acc;
  }
}

// The same product on the tensor cores: 16x16x16 bf16 WMMA tiles, f32
// accumulators, one warp per 16x16 output tile. M, N, K multiples of 16;
// lda/ldb multiples of 8, ldc of 4; tile pointers 32-byte aligned (the
// callers' leading dims and offsets guarantee it).
template <bool A_T, bool B_T, bool ACCUM>
__device__ void gemm_wmma(const bf16* A, int lda, const bf16* B, int ldb,
                          float* C, int ldc, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int tn_count = N >> 4;
  const int tiles = (M >> 4) * tn_count;
  for (int t = warp; t < tiles; t += kWarps) {
    const int tm = t / tn_count, tn = t - tm * tn_count;
    float* c = C + (size_t)(tm * 16) * ldc + tn * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACCUM)
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      typedef typename std::conditional<A_T, wmma::col_major,
                                        wmma::row_major>::type ALayout;
      typedef typename std::conditional<B_T, wmma::col_major,
                                        wmma::row_major>::type BLayout;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
      if (A_T)
        wmma::load_matrix_sync(fa, A + (size_t)kk * lda + tm * 16, lda);
      else
        wmma::load_matrix_sync(fa, A + (size_t)(tm * 16) * lda + kk, lda);
      if (B_T)
        wmma::load_matrix_sync(fb, B + (size_t)(tn * 16) * ldb + kk, ldb);
      else
        wmma::load_matrix_sync(fb, B + (size_t)kk * ldb + tn * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

template <typename T, bool A_T, bool B_T, bool ACCUM>
__device__ __forceinline__ void gemm(const T* A, int lda, const T* B, int ldb,
                                     float* C, int ldc, int M, int N, int K,
                                     bool tc) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (tc) {
      gemm_wmma<A_T, B_T, ACCUM>(A, lda, B, ldb, C, ldc, M, N, K);
      return;
    }
  }
  gemm_fma<T, A_T, B_T, ACCUM>(A, lda, B, ldb, C, ldc, M, N, K);
}

// Per-row mean and 1/sqrt(var + eps) over D, one warp per row.
template <typename Tin>
__device__ void row_stats(const Tin* in, int ld, int rows, int D, float* mu,
                          float* rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const Tin* row = in + (size_t)r * ld;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += to_f(row[d]);
    const float m = warp_sum(s) / D;
    float var = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float t = to_f(row[d]) - m;
      var += t * t;
    }
    var = warp_sum(var) / D;
    if (lane == 0) {
      mu[r] = m;
      rstd[r] = rsqrtf(var + kEps);
    }
  }
}

// rows x D elements of T from global (row stride D) to shared (row stride
// ld), 16 bytes per thread (D * sizeof(T) is a multiple of 16).
template <typename T>
__device__ void load_tile(const T* src, int rows, int D, T* dst, int ld) {
  constexpr int per = 16 / sizeof(T);
  const int vec_row = D / per;
  for (int i = threadIdx.x; i < rows * vec_row; i += kThreads) {
    const int r = i / vec_row, c = (i - r * vec_row) * per;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows x width elements of T from global (row stride src_ld) to shared (row
// stride ld); with ``scaled`` each element becomes T(f32(element) * scale).
// 16 bytes per thread where width, src_ld, ld and src hold whole 16-byte
// vectors (one head's slice of a head-packed [.., D] row with hd * sizeof(T)
// a multiple of 16), else one element per thread (any head dim).
template <typename T>
__device__ void load_head(const T* src, int src_ld, int rows, int width,
                          T* dst, int ld, float scale, bool scaled) {
  constexpr int per = 16 / sizeof(T);
  if (width % per || src_ld % per || ld % per ||
      reinterpret_cast<uintptr_t>(src) % 16) {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      const T e = src[(size_t)r * src_ld + c];
      dst[(size_t)r * ld + c] = scaled ? from_f<T>(to_f(e) * scale) : e;
    }
    return;
  }
  const int vec_row = width / per;
  for (int i = threadIdx.x; i < rows * vec_row; i += kThreads) {
    const int r = i / vec_row, c = (i - r * vec_row) * per;
    uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + c);
    if (scaled) {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < per; ++j) e[j] = from_f<T>(to_f(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) = raw;
  }
}

// Dropout bits: MurmurHash3's 32-bit finalizer, counter based, so that a
// mask is a function of (seed, stream, counter) alone and the backward
// regenerates it. stream = 2 * batch row + site (0: the gate g, 1: the FFN
// activation f); counter = token * width + column. The plain versions
// (ops/fused_block.dropout_bits) compute the same bits with torch int64
// ops; tests/test_torch_fused_block_train.py holds both to a numpy spec.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t drop_key(uint32_t seed, uint32_t stream) {
  return fmix32(seed + 0x9E3779B9u * stream);
}

// keep mask value of one element: 1/(1-p) when kept, else 0
__device__ __forceinline__ float keep_factor(uint32_t key, uint32_t counter,
                                             uint32_t thr, float scale) {
  return fmix32(key ^ fmix32(counter)) >= thr ? scale : 0.0f;
}

// out[i] = sum over g of part[g * P + i], in order of g: the fixed-order
// sum of per-block partials that keeps the weight gradients deterministic
// (csrc/fused_block_bwd.cu)
__global__ void reduce_rows_kernel(const float* part, int G, int P,
                                   float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += part[(size_t)g * P + i];
  out[i] = s;
}

// The same sum for a few hundred columns of thousands of rows (the rel-pos
// gradient's per-tile partials, csrc/hstu_attn_bwd_sm90.cuh), launched with
// blocks of kSplitRows x 32 threads: thread (x, y) takes column blockIdx.x *
// 32 + x and rows y, y + kSplitRows, ... in order, then thread (x, 0) adds
// the kSplitRows partial sums in order of y. A fixed order: deterministic.
constexpr int kSplitRows = 32;

__global__ void __launch_bounds__(32 * kSplitRows)
    reduce_rows_split_kernel(const float* part, int G, int P, float* out) {
  __shared__ float sums[kSplitRows][32];
  const int x = threadIdx.x, y = threadIdx.y, i = blockIdx.x * 32 + x;
  float s = 0.0f;
  if (i < P) {
#pragma unroll 4
    for (int g = y; g < G; g += kSplitRows) s += part[(size_t)g * P + i];
  }
  sums[y][x] = s;
  __syncthreads();
  if (y == 0 && i < P) {
    for (int r = 1; r < kSplitRows; ++r) s += sums[r][x];
    out[i] = s;
  }
}

}  // namespace fbk
