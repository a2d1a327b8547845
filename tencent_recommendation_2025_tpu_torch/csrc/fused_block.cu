// Fused pre-norm HSTU block forward (inference) for Hopper, sm_90a.
//
// Replaces tencent_recommendation_2025_tpu/ops/fused_block.py::_fwd_kernel
// (the whole-sequence Pallas kernel, train=False). Per batch row and token,
// with x [B, L, D] in the compute dtype T (bf16 on the product path, f32 in
// the checks):
//
//   h1   = LN1(x)                                   f32, eps 1e-8
//   uvqk = silu(T(h1) @ Wuvqk + b)                  f32 accumulation
//   u = uvqk[:D] (f32), v = T(uvqk[D:2D] / L), q = T(uvqk[2D:3D] * hd^-1/2),
//   k = T(uvqk[3D:])
//   av_h = sum_{k<=q, valid k} T(silu(q_h.k_h + rab[h, min(q-k, NB-1)])) v_h
//   g    = LN2(av) * u
//   y    = x + T(g) @ Wo + bo
//   out  = T(y + T(silu(x1) * x3) @ W2),  [x1 | x3] = T(LN3(y)) @ W13
//
// Matmul operands are in T with f32 accumulation; every LN, SiLU, gate and
// residual is f32. The rounding points are those of the TPU kernel, so the
// plain PyTorch version (ops/fused_block.fused_hstu_block_plain) agrees to
// accumulation order.
//
// Design. The TPU kernel keeps one batch row's whole [D, L] sequence in VMEM
// and runs a grid of (B,). Here two kernels split the block at its only
// all-to-all dependency, the keys:
//   proj_kernel      grid (L/64, B): LN1 and the D -> 4D projection for 64
//                    tokens; writes q, k, v (compute dtype) and u (f32) to a
//                    scratch the wrapper allocates.
//   attn_ffn_kernel  grid (L/TQ, B): one query tile walks the key tiles up to
//                    the diagonal (causal tiles above it are skipped),
//                    accumulating av in f32 shared memory, then runs LN2 * u,
//                    the out-projection, the residual, LN3, SwiGLU and W2 in
//                    the same block. Heaviest query tiles launch first.
// The rel-pos bias comes straight from rab by distance and the mask is
// multiplicative, so no [L, L] bias or mask tile is ever built.
//
// Bound on the H100 (flagship B=128, L=1024, D=64, F=256, H=1, per block):
// 35.4 GFLOP of products (projection 4.3, q.k^T causal 8.6, a.v 8.6, Wo 1.1,
// W13 8.6, W2 4.3) against 33.5 MB of activation traffic; 36 us at 989
// TFLOP/s bf16 versus 10 us at 3.35 TB/s, so the bound is compute. Products
// run on the tensor cores through WMMA (16x16x16 bf16, f32 accumulate) when
// T is bf16 and the widths are multiples of 16, else as FMA loops (the f32
// instance, which exists so that the card can be checked tightly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 64;      // tokens per projection block
constexpr int kNC = 64;      // output-column chunk of the weight products
constexpr int kLdS = kNC + 4;  // f32 chunk tile leading dim
constexpr int kLdP = kNC + 8;  // compute-dtype chunk tile leading dim
constexpr float kEps = 1e-8f;
constexpr size_t kMaxSmem = 232448;  // H100 opt-in shared memory per block

struct Params {
  const void* x;       // [B, L, D] T
  const int* valid;    // [B, L] nonzero = valid key
  const float* ln;     // [6, D] ln1 g, ln1 b, ln2 g, ln2 b, ln3 g, ln3 b
  const void* wuvqk;   // [D, 4D] T
  const float* buvqk;  // [4D]
  const void* wo;      // [D, D] T
  const float* bo;     // [D]
  const void* w13;     // [D, 2F] T
  const void* w2;      // [F, D] T
  const float* rab;    // [H, NB]
  void* q;             // scratch [B, L, D] T (scaled by hd^-1/2)
  void* k;             // scratch [B, L, D] T
  void* v;             // scratch [B, L, D] T (scaled by 1/L)
  float* u;            // scratch [B, L, D] f32
  void* out;           // [B, L, D] T
  int B, L, D, H, F, NB;
  float scale, inv_len;
};

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

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + __expf(-v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// C[M x N] (f32, ldc) = (ACCUM ? C : 0) + A[M x K] . B, A row-major (lda);
// B is row-major [K x N] (ldb), or with B_T the transpose of a row-major
// [N x K] array (ldb). FMA loops: any widths.
template <typename T, bool B_T, bool ACCUM>
__device__ void gemm_fma(const T* A, int lda, const T* B, int ldb, float* C,
                         int ldc, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i - m * N;
    const T* a = A + (size_t)m * lda;
    float acc = 0.0f;
    if (B_T) {
      const T* bt = B + (size_t)n * ldb;
      for (int kk = 0; kk < K; ++kk) acc += to_f(a[kk]) * to_f(bt[kk]);
    } else {
      for (int kk = 0; kk < K; ++kk)
        acc += to_f(a[kk]) * to_f(B[(size_t)kk * ldb + n]);
    }
    float* c = C + (size_t)m * ldc + n;
    *c = ACCUM ? *c + acc : acc;
  }
}

// The same product on the tensor cores: 16x16x16 bf16 WMMA tiles, f32
// accumulators. M, N, K multiples of 16; lda/ldb multiples of 8, ldc of 4;
// tile pointers 32-byte aligned (the callers' leading dims guarantee it).
template <bool B_T, bool ACCUM>
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
    const bf16* a = A + (size_t)(tm * 16) * lda;
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + kk, lda);
      if (B_T) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, B + (size_t)(tn * 16) * ldb + kk, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, B + (size_t)kk * ldb + tn * 16, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

template <typename T, bool B_T, bool ACCUM>
__device__ __forceinline__ void gemm(const T* A, int lda, const T* B, int ldb,
                                     float* C, int ldc, int M, int N, int K,
                                     bool tc) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (tc) {
      gemm_wmma<B_T, ACCUM>(A, lda, B, ldb, C, ldc, M, N, K);
      return;
    }
  }
  gemm_fma<T, B_T, ACCUM>(A, lda, B, ldb, C, ldc, M, N, K);
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

template <typename T>
size_t proj_smem(int D) {
  return align128((size_t)kTM * (D + 8) * sizeof(T)) +
         align128((size_t)kTM * kLdS * sizeof(float)) +
         2 * align128(kTM * sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) proj_kernel(Params p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldt = D + 8;
  const int b = blockIdx.y, t0 = blockIdx.x * kTM;
  unsigned char* ptr = smem;
  T* hs = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)kTM * ldt * sizeof(T));
  float* cs = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)kTM * kLdS * sizeof(float));
  float* mu = reinterpret_cast<float*>(ptr);
  ptr += align128(kTM * sizeof(float));
  float* rstd = reinterpret_cast<float*>(ptr);

  const size_t row0 = (size_t)b * p.L + t0;
  const T* x = static_cast<const T*>(p.x) + row0 * D;
  row_stats<T>(x, D, kTM, D, mu, rstd);
  __syncthreads();
  const float* g1 = p.ln;
  const float* b1 = p.ln + D;
  for (int i = threadIdx.x; i < kTM * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float h = (to_f(x[i]) - mu[r]) * rstd[r] * g1[d] + b1[d];
    hs[r * ldt + d] = from_f<T>(h);
  }
  __syncthreads();

  const T* w = static_cast<const T*>(p.wuvqk);
  T* qo = static_cast<T*>(p.q);
  T* ko = static_cast<T*>(p.k);
  T* vo = static_cast<T*>(p.v);
  for (int n0 = 0; n0 < 4 * D; n0 += kNC) {
    gemm<T, false, false>(hs, ldt, w + n0, 4 * D, cs, kLdS, kTM, kNC, D, tc);
    __syncthreads();
    for (int i = threadIdx.x; i < kTM * kNC; i += kThreads) {
      const int r = i / kNC, c = i - r * kNC, col = n0 + c;
      const float s = silu(cs[r * kLdS + c] + p.buvqk[col]);
      const int part = col / D, d = col - part * D;
      const size_t o = (row0 + r) * D + d;
      if (part == 0)
        p.u[o] = s;
      else if (part == 1)
        vo[o] = from_f<T>(s * p.inv_len);
      else if (part == 2)
        qo[o] = from_f<T>(s * p.scale);
      else
        ko[o] = from_f<T>(s);
    }
    __syncthreads();
  }
}

template <typename T>
size_t attn_smem(int D, int TQ) {
  const size_t tile = align128((size_t)TQ * (D + 8) * sizeof(T));
  return 3 * tile                                         // q, k, v
         + 2 * align128((size_t)TQ * kLdS * sizeof(float))  // s, s2
         + align128((size_t)TQ * kLdP * sizeof(T))          // p
         + align128((size_t)TQ * (D + 4) * sizeof(float))   // av / y
         + 3 * align128(TQ * sizeof(float));                // kval, mu, rstd
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_ffn_kernel(Params p, int TQ, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, H = p.H, hd = D / H, F = p.F, L = p.L;
  const int ldt = D + 8, ldf = D + 4;
  const int b = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * TQ;
  const bool tc_attn = tc && (hd % 16 == 0);

  unsigned char* ptr = smem;
  const size_t tile = align128((size_t)TQ * ldt * sizeof(T));
  T* qs = reinterpret_cast<T*>(ptr);   // q, then the gate g, then LN3(y)
  ptr += tile;
  T* ks = reinterpret_cast<T*>(ptr);   // k, v; then the FFN sum (f32)
  ptr += tile;
  T* vs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  float* os = reinterpret_cast<float*>(ks);
  float* ss = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TQ * kLdS * sizeof(float));
  float* s2 = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TQ * kLdS * sizeof(float));
  T* ps = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)TQ * kLdP * sizeof(T));
  float* av = reinterpret_cast<float*>(ptr);  // av, then y
  ptr += align128((size_t)TQ * ldf * sizeof(float));
  int* kval = reinterpret_cast<int*>(ptr);
  ptr += align128(TQ * sizeof(float));
  float* mu = reinterpret_cast<float*>(ptr);
  ptr += align128(TQ * sizeof(float));
  float* rstd = reinterpret_cast<float*>(ptr);

  const size_t rowb = (size_t)b * L;
  load_tile<T>(static_cast<const T*>(p.q) + (rowb + q0) * D, TQ, D, qs, ldt);
  for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    av[r * ldf + d] = 0.0f;
  }

  // --- attention: key tiles up to the diagonal ---
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TQ;
    __syncthreads();  // previous tile's products are done with ks/vs/ps
    load_tile<T>(static_cast<const T*>(p.k) + (rowb + k0) * D, TQ, D, ks, ldt);
    load_tile<T>(static_cast<const T*>(p.v) + (rowb + k0) * D, TQ, D, vs, ldt);
    for (int j = threadIdx.x; j < TQ; j += kThreads)
      kval[j] = p.valid[rowb + k0 + j];
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      gemm<T, true, false>(qs + h * hd, ldt, ks + h * hd, ldt, ss, kLdS, TQ,
                           TQ, hd, tc_attn);
      __syncthreads();
      const float* rab = p.rab + (size_t)h * p.NB;
      for (int i = threadIdx.x; i < TQ * TQ; i += kThreads) {
        const int r = i / TQ, c = i - r * TQ;
        const int dist = (q0 + r) - (k0 + c);
        float a = 0.0f;
        if (dist >= 0 && kval[c] != 0)
          a = silu(ss[r * kLdS + c] + rab[min(dist, p.NB - 1)]);
        ps[r * kLdP + c] = from_f<T>(a);
      }
      __syncthreads();
      gemm<T, false, true>(ps, kLdP, vs + h * hd, ldt, av + h * hd, ldf, TQ,
                           hd, TQ, tc_attn);
      __syncthreads();
    }
  }

  // --- gate: g = LN2(av) * u ---
  row_stats<float>(av, ldf, TQ, D, mu, rstd);
  __syncthreads();
  {
    const float* g2 = p.ln + 2 * D;
    const float* b2 = p.ln + 3 * D;
    const float* u = p.u + (rowb + q0) * D;
    for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float g = ((av[r * ldf + d] - mu[r]) * rstd[r] * g2[d] + b2[d]) *
                      u[i];
      qs[r * ldt + d] = from_f<T>(g);
    }
  }
  __syncthreads();

  // --- y = x + g @ Wo + bo, into the av buffer ---
  const T* x = static_cast<const T*>(p.x) + (rowb + q0) * D;
  const T* wo = static_cast<const T*>(p.wo);
  for (int n0 = 0; n0 < D; n0 += kNC) {
    const int nc = min(kNC, D - n0);
    gemm<T, false, false>(qs, ldt, wo + n0, D, ss, kLdS, TQ, nc, D, tc);
    __syncthreads();
    for (int i = threadIdx.x; i < TQ * nc; i += kThreads) {
      const int r = i / nc, c = i - r * nc;
      av[r * ldf + n0 + c] =
          to_f(x[(size_t)r * D + n0 + c]) + ss[r * kLdS + c] + p.bo[n0 + c];
    }
    __syncthreads();
  }

  // --- LN3(y) into qs; zero the FFN sum ---
  row_stats<float>(av, ldf, TQ, D, mu, rstd);
  __syncthreads();
  {
    const float* g3 = p.ln + 4 * D;
    const float* b3 = p.ln + 5 * D;
    for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      qs[r * ldt + d] =
          from_f<T>((av[r * ldf + d] - mu[r]) * rstd[r] * g3[d] + b3[d]);
      os[r * ldf + d] = 0.0f;
    }
  }
  __syncthreads();

  // --- SwiGLU FFN in F-chunks: os += T(silu(x1) * x3) @ W2[chunk] ---
  const T* w13 = static_cast<const T*>(p.w13);
  const T* w2 = static_cast<const T*>(p.w2);
  for (int j0 = 0; j0 < F; j0 += kNC) {
    const int nc = min(kNC, F - j0);
    gemm<T, false, false>(qs, ldt, w13 + j0, 2 * F, ss, kLdS, TQ, nc, D, tc);
    gemm<T, false, false>(qs, ldt, w13 + F + j0, 2 * F, s2, kLdS, TQ, nc, D,
                          tc);
    __syncthreads();
    for (int i = threadIdx.x; i < TQ * nc; i += kThreads) {
      const int r = i / nc, c = i - r * nc;
      ps[r * kLdP + c] = from_f<T>(silu(ss[r * kLdS + c]) * s2[r * kLdS + c]);
    }
    __syncthreads();
    gemm<T, false, true>(ps, kLdP, w2 + (size_t)j0 * D, D, os, ldf, TQ, D, nc,
                         tc);
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out) + (rowb + q0) * D;
  for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[i] = from_f<T>(av[r * ldf + d] + os[r * ldf + d]);
  }
}

template <typename T>
int launch(const Params& p, bool tc, cudaStream_t stream) {
  int TQ = 0;
  for (int t = 64; t >= 16; t >>= 1) {
    if (p.L % t == 0 && attn_smem<T>(p.D, t) <= kMaxSmem) {
      TQ = t;
      break;
    }
  }
  const size_t sm_a = proj_smem<T>(p.D);
  if (TQ == 0 || sm_a > kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t sm_b = attn_smem<T>(p.D, TQ);
  cudaError_t e = cudaFuncSetAttribute(
      proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_ffn_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm_b);
  if (e != cudaSuccess) return (int)e;
  proj_kernel<T><<<dim3(p.L / kTM, p.B), kThreads, sm_a, stream>>>(p, tc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_ffn_kernel<T><<<dim3(p.L / TQ, p.B), kThreads, sm_b, stream>>>(p, TQ,
                                                                      tc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: x/out [B, L, D], valid
// [B, L] int32, ln [6, D] f32, wuvqk [D, 4D], buvqk [4D] f32, wo [D, D],
// bo [D] f32, w13 [D, 2F], w2 [F, D], rab [H, NB] f32, scratch q/k/v
// [B, L, D] in the compute dtype and u [B, L, D] f32. All contiguous, 16-byte
// aligned. Requires L % 64 == 0, D % 16 == 0, F % 16 == 0, D % H == 0.
// Returns a cudaError_t code (0 on success).
extern "C" int fused_block_fwd(int is_bf16, const void* x, const void* valid,
                               const void* ln, const void* wuvqk,
                               const void* buvqk, const void* wo,
                               const void* bo, const void* w13,
                               const void* w2, const void* rab, void* q,
                               void* k, void* v, void* u, void* out, int B,
                               int L, int D, int H, int F, int NB, float scale,
                               float inv_len, void* stream) {
  if (L % kTM != 0 || D % 16 != 0 || F % 16 != 0 || H <= 0 || D % H != 0 ||
      NB <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.valid = static_cast<const int*>(valid);
  p.ln = static_cast<const float*>(ln);
  p.wuvqk = wuvqk;
  p.buvqk = static_cast<const float*>(buvqk);
  p.wo = wo;
  p.bo = static_cast<const float*>(bo);
  p.w13 = w13;
  p.w2 = w2;
  p.rab = static_cast<const float*>(rab);
  p.q = q;
  p.k = k;
  p.v = v;
  p.u = static_cast<float*>(u);
  p.out = out;
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.F = F;
  p.NB = NB;
  p.scale = scale;
  p.inv_len = inv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(p, true, s);
  return launch<float>(p, false, s);
}
