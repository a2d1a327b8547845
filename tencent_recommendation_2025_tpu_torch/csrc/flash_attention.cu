// Causal, key-padding-masked softmax attention ("flash MHA") for Hopper,
// sm_90a: forward and backward.
//
// Replaces tencent_recommendation_2025_tpu/ops/flash_attention.py::
// _fwd_kernel (l.50) with flash_fwd_kernel, and ::_bwd_kernel (l.81) with
// flash_bwd_dq_kernel and flash_bwd_dkdv_kernel. Per batch row and head h,
// with q, k, v, dout [B, L, D] head-packed (D = H * hd) in the compute
// dtype T (bf16 on the product path, f32 in the checks):
//
//   qs = T(q_h * hd^-1/2)                      (rounded before q.k^T)
//   s  = qs k_h^T                              f32 accumulation
//   p  = exp(s - max) * mask / max(sum, 1e-30) over the causal, valid keys;
//        a query row with no valid key gives p = 0, hence out = 0
//   out_h = T(p) v_h                           f32 accumulation, out in T
//
//   backward (p recomputed in f32): dv = T(p)^T do; dp = do v^T;
//   delta = rowsum(dp * p); ds = T(p * (dp - delta)); dq = ds k * hd^-1/2;
//   dk = ds^T qs; dq, dk, dv in T.
//
// These are the TPU kernel's rounding points. A streaming (online) softmax
// would round the unnormalised exp before p.v; instead every query tile
// first walks its key tiles for the row max and sum (the sum rescaled as
// the max grows), then walks them again with p normalised before it is
// rounded. The backward takes delta = rowsum(dp * p) as the TPU kernel
// does, not rowsum(do * out), which equals it only in exact arithmetic.
//
// Design. The TPU kernel runs a grid of (B,) over one row's whole [L, D]
// in VMEM with a static loop over 128-query stripes and heads. Here one
// block of 256 threads owns one (query tile, head, batch row) and streams
// key tiles of its head's slice through shared memory, up to the diagonal
// (tiles above it are skipped; the heaviest query tiles launch first).
// Tiles are TQ = 64 rows, or 32 or 16 where a wide head (hd up to 256)
// would not fit 227 KB of shared memory. Products are 16x16x16 WMMA
// tiles, bf16 with f32 accumulators, where hd % 16 == 0; FMA loops
// otherwise (any hd, as the TPU kernel slices any head) and for T = f32
// (the check instance); every softmax step is f32, one warp per query row.
// The backward is two kernels: flash_bwd_dq walks the key tiles of one
// query tile three times (max and sum, delta, then ds and dq) and leaves
// each row's max, sum and delta in a scratch; flash_bwd_dkdv then walks
// the query tiles at or below one key tile's diagonal, recomputes p and ds
// from those and sums dk and dv. No atomics: the results are deterministic.
//
// Bound on the H100 at baseline_o1's shape (B=128, L=1024, D=64, H=1):
// forward 17.2 GFLOP of causal products (q.k^T and p.v, L(L+1)/2 pairs a
// row) against 67 MB of q, k, v and out: 0.020 ms, bound by bytes at 3.35
// TB/s; backward 43.0 GFLOP (s, dp, dv, dq, dk) against 117 MB: 0.044 ms,
// bound by operations at 989 TFLOP/s. This first kernel recomputes s
// three times in flash_bwd_dq and once in each other pass, so it does
// about twice the forward's and the backward's bound work.

#include <cfloat>

#include "fused_block_common.cuh"

using namespace fbk;

namespace {

constexpr float kNeg = -FLT_MAX;       // finfo(f32).min, the masked score
constexpr int kMaxHd = 256;            // widest head slice the kernels take

struct FlashArgs {
  const void* q;       // [B, L, D] T
  const void* k;       // [B, L, D] T
  const void* v;       // [B, L, D] T
  const int* valid;    // [B, L] nonzero = valid key
  const void* dout;    // backward: [B, L, D] T
  void* out;           // forward: [B, L, D] T
  void* dq;            // backward: [B, L, D] T
  void* dk;            // backward: [B, L, D] T
  void* dv;            // backward: [B, L, D] T
  float* stats;        // backward scratch [3, B, H, L]: row max, sum, delta
  int B, L, D, H;
  float scale;         // hd^-1/2
};

__device__ __forceinline__ bool visible(int q, int k, const int* kval,
                                        int c) {
  return q >= k && kval[c] != 0;
}

template <typename T>
size_t fwd_smem(int hd, int TQ) {
  return 3 * align128((size_t)TQ * (hd + 8) * sizeof(T))  // q, k, v
         + align128((size_t)TQ * kLdS * sizeof(float))     // s
         + align128((size_t)TQ * kLdP * sizeof(T))         // T(p)
         + align128((size_t)TQ * (hd + 4) * sizeof(float)) // out sum
         + align128(TQ * sizeof(int));                     // key valid
}

// Row max and rescaled row sum of exp over the visible keys of one score
// tile, one warp per row (rows warp * rows + i, columns lane, lane + 32).
template <int TQ>
__device__ __forceinline__ void online_stats(const float* ss, int q0, int k0,
                                             const int* kval, float* m,
                                             float* z) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int rows = TQ / kWarps;
#pragma unroll
  for (int i = 0; i < rows; ++i) {
    const int r = warp * rows + i;
    float tmax = kNeg;
    for (int c = lane; c < TQ; c += 32)
      if (visible(q0 + r, k0 + c, kval, c))
        tmax = fmaxf(tmax, ss[r * kLdS + c]);
    const float mn = fmaxf(m[i], warp_max(tmax));
    float e = 0.0f;
    for (int c = lane; c < TQ; c += 32)
      if (visible(q0 + r, k0 + c, kval, c)) e += expf(ss[r * kLdS + c] - mn);
    z[i] = z[i] * expf(m[i] - mn) + warp_sum(e);
    m[i] = mn;
  }
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(FlashArgs p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, hd = D / p.H, L = p.L;
  const int ldh = hd + 8, lda = hd + 4;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TQ;
  constexpr int rows = TQ / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  unsigned char* ptr = smem;
  const size_t tile = align128((size_t)TQ * ldh * sizeof(T));
  T* qs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* ks = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* vs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  float* ss = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TQ * kLdS * sizeof(float));
  T* ps = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)TQ * kLdP * sizeof(T));
  float* acc = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TQ * lda * sizeof(float));
  int* kval = reinterpret_cast<int*>(ptr);

  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const T* K = static_cast<const T*>(p.k) + col;
  const T* V = static_cast<const T*>(p.v) + col;
  load_head<T>(static_cast<const T*>(p.q) + (rowb + q0) * D + col, D, TQ, hd,
               qs, ldh, p.scale, true);
  for (int i = threadIdx.x; i < TQ * hd; i += kThreads)
    acc[(i / hd) * lda + i % hd] = 0.0f;

  float m[rows], z[rows];
#pragma unroll
  for (int i = 0; i < rows; ++i) {
    m[i] = kNeg;
    z[i] = 0.0f;
  }
  // --- pass 1: each row's max and sum over its visible keys ---
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TQ;
    __syncthreads();  // the previous tile is done with ks and ss
    load_head<T>(K + (rowb + k0) * D, D, TQ, hd, ks, ldh, 1.0f, false);
    for (int j = threadIdx.x; j < TQ; j += kThreads)
      kval[j] = p.valid[rowb + k0 + j];
    __syncthreads();
    gemm<T, false, true, false>(qs, ldh, ks, ldh, ss, kLdS, TQ, TQ, hd, tc);
    __syncthreads();
    online_stats<TQ>(ss, q0, k0, kval, m, z);
  }
  // --- pass 2: out += T(p) v with p normalised before it is rounded ---
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TQ;
    __syncthreads();  // the previous tile's products are done
    load_head<T>(K + (rowb + k0) * D, D, TQ, hd, ks, ldh, 1.0f, false);
    load_head<T>(V + (rowb + k0) * D, D, TQ, hd, vs, ldh, 1.0f, false);
    for (int j = threadIdx.x; j < TQ; j += kThreads)
      kval[j] = p.valid[rowb + k0 + j];
    __syncthreads();
    gemm<T, false, true, false>(qs, ldh, ks, ldh, ss, kLdS, TQ, TQ, hd, tc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < rows; ++i) {
      const int r = warp * rows + i;
      const float zz = fmaxf(z[i], 1e-30f);
      for (int c = lane; c < TQ; c += 32) {
        float pv = 0.0f;
        if (visible(q0 + r, k0 + c, kval, c))
          pv = expf(ss[r * kLdS + c] - m[i]) / zz;
        ps[r * kLdP + c] = from_f<T>(pv);
      }
    }
    __syncthreads();
    gemm<T, false, false, true>(ps, kLdP, vs, ldh, acc, lda, TQ, hd, TQ, tc);
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + (rowb + q0) * D + col;
  for (int i = threadIdx.x; i < TQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    out[(size_t)r * D + d] = from_f<T>(acc[r * lda + d]);
  }
}

template <typename T>
size_t bwd_smem(int hd, int TQ) {
  return 4 * align128((size_t)TQ * (hd + 8) * sizeof(T))   // q, do, k, v
         + 2 * align128((size_t)TQ * kLdS * sizeof(float))  // s, dp
         + 2 * align128((size_t)TQ * kLdP * sizeof(T))      // T(p), T(ds)
         + 2 * align128((size_t)TQ * (hd + 4) * sizeof(float))  // sums
         + align128(TQ * sizeof(int))                       // key valid
         + 3 * align128(TQ * sizeof(float));                // row stats
}

// The shared-memory carve-out of both backward kernels.
template <typename T>
struct BwdTiles {
  T *qs, *dos, *ks, *vs, *ps, *dss;
  float *ss, *dps, *acc1, *acc2, *rm, *rz, *rd;
  int* kval;

  __device__ BwdTiles(unsigned char* ptr, int hd, int TQ) {
    const size_t tile = align128((size_t)TQ * (hd + 8) * sizeof(T));
    const size_t ftile = align128((size_t)TQ * kLdS * sizeof(float));
    const size_t ptile = align128((size_t)TQ * kLdP * sizeof(T));
    const size_t atile = align128((size_t)TQ * (hd + 4) * sizeof(float));
    const size_t row = align128(TQ * sizeof(float));
    qs = reinterpret_cast<T*>(ptr);
    dos = reinterpret_cast<T*>(ptr + tile);
    ks = reinterpret_cast<T*>(ptr + 2 * tile);
    vs = reinterpret_cast<T*>(ptr + 3 * tile);
    ptr += 4 * tile;
    ss = reinterpret_cast<float*>(ptr);
    dps = reinterpret_cast<float*>(ptr + ftile);
    ptr += 2 * ftile;
    ps = reinterpret_cast<T*>(ptr);
    dss = reinterpret_cast<T*>(ptr + ptile);
    ptr += 2 * ptile;
    acc1 = reinterpret_cast<float*>(ptr);
    acc2 = reinterpret_cast<float*>(ptr + atile);
    ptr += 2 * atile;
    kval = reinterpret_cast<int*>(ptr);
    ptr += row;
    rm = reinterpret_cast<float*>(ptr);
    rz = reinterpret_cast<float*>(ptr + row);
    rd = reinterpret_cast<float*>(ptr + 2 * row);
  }
};

// dq of one query tile, walking its key tiles three times: max and sum,
// delta = rowsum(dp * p), then ds and dq. Leaves max, sum and delta per
// row in p.stats for flash_bwd_dkdv_kernel.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(FlashArgs p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, H = p.H, hd = D / H, L = p.L;
  const int ldh = hd + 8, lda = hd + 4;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TQ;
  constexpr int rows = TQ / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  BwdTiles<T> t(smem, hd, TQ);

  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const T* K = static_cast<const T*>(p.k) + col;
  const T* V = static_cast<const T*>(p.v) + col;
  load_head<T>(static_cast<const T*>(p.q) + (rowb + q0) * D + col, D, TQ, hd,
               t.qs, ldh, p.scale, true);
  load_head<T>(static_cast<const T*>(p.dout) + (rowb + q0) * D + col, D, TQ,
               hd, t.dos, ldh, 1.0f, false);
  for (int i = threadIdx.x; i < TQ * hd; i += kThreads)
    t.acc1[(i / hd) * lda + i % hd] = 0.0f;

  float m[rows], z[rows], delta[rows];
#pragma unroll
  for (int i = 0; i < rows; ++i) {
    m[i] = kNeg;
    z[i] = 0.0f;
    delta[i] = 0.0f;
  }
  for (int pass = 0; pass < 3; ++pass) {
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * TQ;
      __syncthreads();  // the previous tile is done with every buffer
      load_head<T>(K + (rowb + k0) * D, D, TQ, hd, t.ks, ldh, 1.0f, false);
      if (pass > 0)
        load_head<T>(V + (rowb + k0) * D, D, TQ, hd, t.vs, ldh, 1.0f, false);
      for (int j = threadIdx.x; j < TQ; j += kThreads)
        t.kval[j] = p.valid[rowb + k0 + j];
      __syncthreads();
      gemm<T, false, true, false>(t.qs, ldh, t.ks, ldh, t.ss, kLdS, TQ, TQ,
                                  hd, tc);
      if (pass > 0)
        gemm<T, false, true, false>(t.dos, ldh, t.vs, ldh, t.dps, kLdS, TQ,
                                    TQ, hd, tc);
      __syncthreads();
      if (pass == 0) {
        online_stats<TQ>(t.ss, q0, k0, t.kval, m, z);
        continue;
      }
#pragma unroll
      for (int i = 0; i < rows; ++i) {
        const int r = warp * rows + i;
        const float zz = fmaxf(z[i], 1e-30f);
        float sum = 0.0f;
        for (int c = lane; c < TQ; c += 32) {
          float pv = 0.0f;
          if (visible(q0 + r, k0 + c, t.kval, c))
            pv = expf(t.ss[r * kLdS + c] - m[i]) / zz;
          const float dp = t.dps[r * kLdS + c];
          if (pass == 1)
            sum += dp * pv;
          else
            t.dss[r * kLdP + c] = from_f<T>(pv * (dp - delta[i]));
        }
        if (pass == 1) delta[i] += warp_sum(sum);
      }
      if (pass == 2) {
        __syncthreads();
        // dq += T(ds) k
        gemm<T, false, false, true>(t.dss, kLdP, t.ks, ldh, t.acc1, lda, TQ,
                                    hd, TQ, tc);
      }
    }
  }
  __syncthreads();
  T* dq = static_cast<T*>(p.dq) + (rowb + q0) * D + col;
  for (int i = threadIdx.x; i < TQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    dq[(size_t)r * D + d] = from_f<T>(t.acc1[r * lda + d] * p.scale);
  }
  if (lane == 0) {
    const size_t plane = (size_t)p.B * H * L;
    const size_t o = ((size_t)b * H + h) * L + q0 + warp * rows;
#pragma unroll
    for (int i = 0; i < rows; ++i) {
      p.stats[o + i] = m[i];
      p.stats[plane + o + i] = z[i];
      p.stats[2 * plane + o + i] = delta[i];
    }
  }
}

// dk and dv of one key tile, walking the query tiles at or below its
// diagonal with p and ds recomputed from the rows' max, sum and delta.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(FlashArgs p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, H = p.H, hd = D / H, L = p.L;
  const int ldh = hd + 8, lda = hd + 4;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * TQ;
  BwdTiles<T> t(smem, hd, TQ);
  float* dk = t.acc1;
  float* dv = t.acc2;

  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  load_head<T>(static_cast<const T*>(p.k) + (rowb + k0) * D + col, D, TQ, hd,
               t.ks, ldh, 1.0f, false);
  load_head<T>(static_cast<const T*>(p.v) + (rowb + k0) * D + col, D, TQ, hd,
               t.vs, ldh, 1.0f, false);
  for (int j = threadIdx.x; j < TQ; j += kThreads)
    t.kval[j] = p.valid[rowb + k0 + j];
  for (int i = threadIdx.x; i < TQ * hd; i += kThreads) {
    dk[(i / hd) * lda + i % hd] = 0.0f;
    dv[(i / hd) * lda + i % hd] = 0.0f;
  }
  const size_t plane = (size_t)p.B * H * L;
  const float* stats = p.stats + ((size_t)b * H + h) * L;

  for (int qt = kt; qt < L / TQ; ++qt) {
    const int q0 = qt * TQ;
    __syncthreads();  // the previous query tile is done with every buffer
    load_head<T>(static_cast<const T*>(p.q) + (rowb + q0) * D + col, D, TQ,
                 hd, t.qs, ldh, p.scale, true);
    load_head<T>(static_cast<const T*>(p.dout) + (rowb + q0) * D + col, D,
                 TQ, hd, t.dos, ldh, 1.0f, false);
    for (int j = threadIdx.x; j < TQ; j += kThreads) {
      t.rm[j] = stats[q0 + j];
      t.rz[j] = fmaxf(stats[plane + q0 + j], 1e-30f);
      t.rd[j] = stats[2 * plane + q0 + j];
    }
    __syncthreads();
    gemm<T, false, true, false>(t.qs, ldh, t.ks, ldh, t.ss, kLdS, TQ, TQ, hd,
                                tc);
    gemm<T, false, true, false>(t.dos, ldh, t.vs, ldh, t.dps, kLdS, TQ, TQ,
                                hd, tc);
    __syncthreads();
    for (int i = threadIdx.x; i < TQ * TQ; i += kThreads) {
      const int r = i / TQ, c = i - r * TQ;
      float pv = 0.0f;
      if (visible(q0 + r, k0 + c, t.kval, c))
        pv = expf(t.ss[r * kLdS + c] - t.rm[r]) / t.rz[r];
      t.ps[r * kLdP + c] = from_f<T>(pv);
      t.dss[r * kLdP + c] = from_f<T>(pv * (t.dps[r * kLdS + c] - t.rd[r]));
    }
    __syncthreads();
    // dv += T(p)^T do;  dk += T(ds)^T qs
    gemm<T, true, false, true>(t.ps, kLdP, t.dos, ldh, dv, lda, TQ, hd, TQ,
                               tc);
    gemm<T, true, false, true>(t.dss, kLdP, t.qs, ldh, dk, lda, TQ, hd, TQ,
                               tc);
  }
  __syncthreads();
  T* dko = static_cast<T*>(p.dk) + (rowb + k0) * D + col;
  T* dvo = static_cast<T*>(p.dv) + (rowb + k0) * D + col;
  for (int i = threadIdx.x; i < TQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    dko[(size_t)r * D + d] = from_f<T>(dk[r * lda + d]);
    dvo[(size_t)r * D + d] = from_f<T>(dv[r * lda + d]);
  }
}

bool shapes_ok(int B, int L, int D, int H) {
  if (B <= 0 || H <= 0 || L <= 0 || L % 64 != 0 || D % H != 0) return false;
  return D / H <= kMaxHd;
}

// The query/key tile: 64 rows, or 32 or 16 where the head slice would not
// fit shared memory at 64 (0: none fits).
template <typename T>
int pick_tile(int hd, bool bwd) {
  for (int t = 64; t >= 16; t >>= 1)
    if ((bwd ? bwd_smem<T>(hd, t) : fwd_smem<T>(hd, t)) <= kMaxSmem) return t;
  return 0;
}

template <typename T>
bool use_tc(int hd) {
  return std::is_same<T, bf16>::value && hd % 16 == 0;
}

template <typename T, int TQ>
int launch_fwd_tiles(const FlashArgs& p, cudaStream_t stream) {
  const int hd = p.D / p.H;
  const size_t sm = fwd_smem<T>(hd, TQ);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.L / TQ, p.H, p.B);
  flash_fwd_kernel<T, TQ><<<grid, kThreads, sm, stream>>>(p, use_tc<T>(hd));
  return (int)cudaGetLastError();
}

template <typename T, int TQ>
int launch_bwd_tiles(const FlashArgs& p, cudaStream_t stream) {
  const int hd = p.D / p.H;
  const size_t sm = bwd_smem<T>(hd, TQ);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, TQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm);
  if (e != cudaSuccess) return (int)e;
  const bool tc = use_tc<T>(hd);
  const dim3 grid(p.L / TQ, p.H, p.B);
  flash_bwd_dq_kernel<T, TQ><<<grid, kThreads, sm, stream>>>(p, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, TQ><<<grid, kThreads, sm, stream>>>(p, tc);
  return (int)cudaGetLastError();
}

// The tile rows are a template argument, so that each warp's row state
// (max, sum, delta) stays in registers.
template <typename T>
int launch_fwd(const FlashArgs& p, cudaStream_t stream) {
  switch (pick_tile<T>(p.D / p.H, false)) {
    case 64: return launch_fwd_tiles<T, 64>(p, stream);
    case 32: return launch_fwd_tiles<T, 32>(p, stream);
    case 16: return launch_fwd_tiles<T, 16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_bwd(const FlashArgs& p, cudaStream_t stream) {
  switch (pick_tile<T>(p.D / p.H, true)) {
    case 64: return launch_bwd_tiles<T, 64>(p, stream);
    case 32: return launch_bwd_tiles<T, 32>(p, stream);
    case 16: return launch_bwd_tiles<T, 16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v, out, dout, dq, dk, dv
// [B, L, D] head-packed in the compute dtype (bf16 when is_bf16, else
// f32), valid [B, L] int32, stats [3, B, H, L] f32 scratch; all
// contiguous and 16-byte aligned. Requires L % 64 == 0, D % H == 0 and
// hd = D / H at most 256. Each returns a cudaError_t code (0 on success).
extern "C" int flash_attn_fwd(int is_bf16, const void* q, const void* k,
                              const void* v, const void* valid, void* out,
                              int B, int L, int D, int H, float scale,
                              void* stream) {
  if (!shapes_ok(B, L, D, H)) return (int)cudaErrorInvalidValue;
  FlashArgs p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int*>(valid);
  p.out = out;
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<bf16>(p, s) : launch_fwd<float>(p, s);
}

extern "C" int flash_attn_bwd(int is_bf16, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* valid, void* dq, void* dk, void* dv,
                              void* stats, int B, int L, int D, int H,
                              float scale, void* stream) {
  if (!shapes_ok(B, L, D, H)) return (int)cudaErrorInvalidValue;
  FlashArgs p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int*>(valid);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = static_cast<float*>(stats);
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<bf16>(p, s) : launch_bwd<float>(p, s);
}
