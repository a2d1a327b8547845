// Causal, key-padding-masked softmax attention ("flash MHA") for Hopper,
// sm_90a: forward and backward.
//
// Replaces tencent_recommendation_2025_tpu/ops/flash_attention.py::
// _fwd_kernel (l.50) with flash_fwd_wgmma_kernel (flash_fwd_kernel for f32
// and wide heads), and ::_bwd_kernel (l.81) with flash_bwd_dq_wgmma_kernel
// and flash_bwd_dkdv_wgmma_kernel (flash_bwd_dq_kernel and
// flash_bwd_dkdv_kernel). Per batch row and head h, with q, k, v, dout
// [B, L, D] head-packed (D = H * hd) in the compute dtype T (bf16 on the
// product path, f32 in the checks):
//
//   qs = T(q_h * hd^-1/2)                      (rounded before q.k^T)
//   s  = qs k_h^T                              f32 accumulation
//   p  = exp(s - max) * mask / max(sum, 1e-30) over the causal, valid keys;
//        a query row with no valid key gives p = 0, hence out = 0
//   out_h = T(p) v_h                           f32 accumulation, out in T
//
//   backward (p recomputed in f32 from the forward's max and sum): dv =
//   T(p)^T do; dp = do v^T; delta = rowsum(dp * p); ds = T(p * (dp -
//   delta)); dq = ds k * hd^-1/2; dk = ds^T qs; dq, dk, dv in T.
//
// These are the TPU kernel's rounding points. A streaming (online) softmax
// would round the unnormalised exp before p.v; instead every query tile
// first walks its key tiles for the row max and sum (the sum rescaled as
// the max grows), then walks them again with p normalised before it is
// rounded. The forward writes each row's max and sum (stats [2, B, H, L]
// f32; max = finfo(f32).min and sum = 0 on a row with no visible key), and
// the backward reads them instead of recomputing them. It takes delta =
// rowsum(dp * p) as the TPU kernel does, not rowsum(do * out), which equals
// it only in exact arithmetic.
//
// Which kernel takes which shape. bf16 with hd <= 128 (every preset) takes
// the wgmma kernels, the head slice zero-padded in shared memory to W = 16,
// 32, 64 or 128 columns. f32 (the tight check instance: Hopper has no f32
// tensor-core product at full precision) and hd 129-256 (one head of D >
// 128 at L = 256 under the gate, in no preset; its dk and dv accumulators
// would not fit in registers) keep the first kernels: 256 threads, 16x16x16
// WMMA through shared-memory accumulators where hd % 16 == 0 in bf16, FMA
// loops otherwise, tiles of 64 rows cut to 32 or 16 where a wide head would
// not fit 227 KB of shared memory.
//
// The wgmma kernels (csrc/sm90_mma.cuh). One block is one warpgroup of 128
// threads and owns one 64-row tile of one (head, batch row); the heaviest
// tiles launch first. Operands sit in swizzled shared-memory tiles (128-byte
// swizzle at W >= 64, 64-byte at 32, 32-byte at 16) that wgmma reads
// through descriptors; accumulators stay in registers; the softmax runs in
// the accumulator layout, each row's values in one quad of threads, with
// exp2 on the special-function unit (ex2.approx). Key (or query) tiles
// stream through a two-stage ring filled by cp.async from precomputed chunk
// offsets, so the next tile loads while this one is multiplied. The barrier
// that admits a tile also votes whether all its keys are valid: such a
// tile below the diagonal takes an elementwise path with no mask.
//
// - forward, one block per query tile: walk 1, S = Qs.K^T (SS: both
//   operands in shared memory) and the online max and sum; walk 2, S again,
//   p normalised in registers, rounded in place to bf16 A fragments, and
//   O += T(P).V (RS: A from registers, V as an MN-major B). 3 products per
//   (query, key) tile pair.
// - dq kernel, one block per query tile: walk 1, S and dP = dO.V^T, p from
//   the stats, delta += rowsum(dp * p); walk 2, S, dP, ds, dQ += T(ds).K.
//   Writes dq and delta (a [B, H, L] f32 scratch). 5 products a pair.
// - dk/dv kernel, one block per key tile, walking the query tiles at or
//   below its diagonal: S^T = K.Qs^T and dP^T = V.dO^T directly, so that
//   T(p)^T and T(ds)^T are register A operands of dV += T(p)^T.dO and
//   dK += T(ds)^T.Qs. 4 products a pair. No atomics: deterministic.
//
// Bound on the H100 at baseline_o1's shape (B=128, L=1024, D=64, H=1):
// forward 17.2 GFLOP of causal products (q.k^T and p.v, L(L+1)/2 pairs a
// row) against 67 MB of q, k, v and out: 0.020 ms, bound by bytes at 3.35
// TB/s; backward 43.0 GFLOP (s, dp, dv, dq, dk) against 117 MB: 0.044 ms,
// bound by operations at 989 TFLOP/s. The wgmma kernels do 1.5x the
// forward's bound products (the two-pass softmax) and 1.8x the backward's
// (s and dp in both kernels, twice in dq), plus the diagonal tiles' masked
// half.

#include <cfloat>

#include "fused_block_common.cuh"
#include "sm90_mma.cuh"

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
  float* stats;        // [2, B, H, L]: row max, sum (forward writes)
  float* delta;        // backward scratch [B, H, L]: rowsum(dp * p)
  int B, L, D, H;
  float scale;         // hd^-1/2
  bool vec;            // head slices in whole 16-byte chunks, aligned
};

__device__ __forceinline__ bool visible(int q, int k, const int* kval,
                                        int c) {
  return q >= k && kval[c] != 0;
}

// ===========================================================================
// The first kernels: f32, and bf16 at hd 129-256
// ===========================================================================

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
  if (lane == 0) {
    const size_t plane = (size_t)p.B * p.H * L;
    const size_t o = ((size_t)b * p.H + h) * L + q0 + warp * rows;
#pragma unroll
    for (int i = 0; i < rows; ++i) {
      p.stats[o + i] = m[i];
      p.stats[plane + o + i] = z[i];
    }
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

// dq of one query tile, walking its key tiles twice with each row's max
// and sum from the forward: delta = rowsum(dp * p), then ds and dq. Leaves
// delta per row in p.delta for flash_bwd_dkdv_kernel.
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

  const size_t plane = (size_t)p.B * H * L;
  const size_t o = ((size_t)b * H + h) * L + q0 + warp * rows;
  float m[rows], z[rows], delta[rows];
#pragma unroll
  for (int i = 0; i < rows; ++i) {
    m[i] = p.stats[o + i];
    z[i] = fmaxf(p.stats[plane + o + i], 1e-30f);
    delta[i] = 0.0f;
  }
  for (int pass = 1; pass < 3; ++pass) {
    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * TQ;
      __syncthreads();  // the previous tile is done with every buffer
      load_head<T>(K + (rowb + k0) * D, D, TQ, hd, t.ks, ldh, 1.0f, false);
      load_head<T>(V + (rowb + k0) * D, D, TQ, hd, t.vs, ldh, 1.0f, false);
      for (int j = threadIdx.x; j < TQ; j += kThreads)
        t.kval[j] = p.valid[rowb + k0 + j];
      __syncthreads();
      gemm<T, false, true, false>(t.qs, ldh, t.ks, ldh, t.ss, kLdS, TQ, TQ,
                                  hd, tc);
      gemm<T, false, true, false>(t.dos, ldh, t.vs, ldh, t.dps, kLdS, TQ,
                                  TQ, hd, tc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < rows; ++i) {
        const int r = warp * rows + i;
        float sum = 0.0f;
        for (int c = lane; c < TQ; c += 32) {
          float pv = 0.0f;
          if (visible(q0 + r, k0 + c, t.kval, c))
            pv = expf(t.ss[r * kLdS + c] - m[i]) / z[i];
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
#pragma unroll
    for (int i = 0; i < rows; ++i) p.delta[o + i] = delta[i];
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
  const size_t srow = ((size_t)b * H + h) * L;

  for (int qt = kt; qt < L / TQ; ++qt) {
    const int q0 = qt * TQ;
    __syncthreads();  // the previous query tile is done with every buffer
    load_head<T>(static_cast<const T*>(p.q) + (rowb + q0) * D + col, D, TQ,
                 hd, t.qs, ldh, p.scale, true);
    load_head<T>(static_cast<const T*>(p.dout) + (rowb + q0) * D + col, D,
                 TQ, hd, t.dos, ldh, 1.0f, false);
    for (int j = threadIdx.x; j < TQ; j += kThreads) {
      t.rm[j] = p.stats[srow + q0 + j];
      t.rz[j] = fmaxf(p.stats[plane + srow + q0 + j], 1e-30f);
      t.rd[j] = p.delta[srow + q0 + j];
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

// ===========================================================================
// The wgmma kernels: bf16, hd <= 128 padded to W columns
// ===========================================================================

constexpr int kTile = sm90::kRows;   // query and key tile rows
constexpr int kWg = sm90::kWgThreads;

using sm90::acc_col;
using sm90::acc_row;
using sm90::accumulate;
using sm90::aligned16;
using sm90::Carve;
using sm90::kLog2e;
using sm90::kStages;
using sm90::scores;
using sm90::wgmma_width;

// Bits of this thread's 32 accumulator elements (S = Q.K^T layout: rows
// queries, columns keys) that are visible: key valid and, on the diagonal
// tile, at or before the query.
__device__ __forceinline__ uint32_t visible_bits(const int* kv, bool diag) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(i), c = acc_col(i);
    if (kv[c] != 0 && (!diag || r >= c)) bits |= 1u << i;
  }
  return bits;
}

// Writes this thread's part of a 64 x W accumulator, times `scale`, as
// bf16 to rows of `out` (row stride D), the first hd columns.
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2],
                                           bf16* out, int D, int hd,
                                           float scale) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int r = acc_row(i), c = acc_col(i);
    bf16* o = out + (size_t)r * D + c;
    if ((hd & 1) == 0) {
      if (c < hd)
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    } else {
      if (c < hd) o[0] = __float2bfloat16_rn(acc[i] * scale);
      if (c + 1 < hd) o[1] = __float2bfloat16_rn(acc[i + 1] * scale);
    }
  }
}

// One thread's part of copying a head slice's 64 x hd tile into a ring
// stage: cp.async by precomputed chunks where the slice is in whole 16-byte
// chunks (p.vec), else element by element through registers.
template <int W>
__device__ __forceinline__ void load_head_tile(const sm90::TileCopy<W>& cp,
                                               bf16* t, const bf16* src,
                                               const FlashArgs& p, int hd) {
  if (p.vec)
    cp.async(t, src);
  else
    sm90::load_tile_sync<W>(t, src, p.D, kTile, hd, kWg, false, 1.0f, false);
}

// held tiles; tiles per ring stage
template <int W>
__host__ __device__ Carve<W> fwd_carve() {   // q; k, v
  return Carve<W>{1, 2};
}
template <int W>
__host__ __device__ Carve<W> bwd_carve() {   // dq: q, do; k, v. dk/dv: k,
  return Carve<W>{2, 2};                      // v; q, do
}

// The elementwise steps run in two instances: `masked` tests each
// element's visibility bit; the other serves tiles below the diagonal
// whose keys are all valid (most tiles), where every element is visible.
using Masked = std::true_type;
using Dense = std::false_type;

template <int W>
__global__ void __launch_bounds__(kWg) flash_fwd_wgmma_kernel(FlashArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const Carve<W> cv = fwd_carve<W>();
  const int D = p.D, H = p.H, hd = D / H, L = p.L, tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile, n = qt + 1;
  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const bf16* K = static_cast<const bf16*>(p.k) + col;
  const bf16* V = static_cast<const bf16*>(p.v) + col;
  bf16* qs = cv.held(base, 0);
  const sm90::TileCopy<W> cp(D, hd);

  // the loads never write the padding columns hd..W-1: zero them once
  if (hd < W) sm90::zero_smem(base, cv.bytes() - 1024, kWg);
  __syncthreads();
  sm90::load_tile_sync<W>(qs, static_cast<const bf16*>(p.q) +
                                  (rowb + q0) * D + col,
                          D, kTile, hd, kWg, p.vec, p.scale, true);

  // step s < n: walk 1 over key tile s (k); s >= n: walk 2 over s - n (k, v)
  auto issue = [&](int s) {
    if (s < 2 * n) {
      const int kt = s < n ? s : s - n, st = s % kStages;
      const size_t r0 = rowb + (size_t)kt * kTile;
      load_head_tile<W>(cp, cv.tile(base, st, 0), K + r0 * D, p, hd);
      if (s >= n)
        load_head_tile<W>(cp, cv.tile(base, st, 1), V + r0 * D, p, hd);
      if (tid < kTile)
        sm90::cp_async4(reinterpret_cast<int*>(cv.rows(base, st)) + tid,
                        p.valid + r0 + tid);
    }
    sm90::cp_async_commit();
  };

  float m[2] = {kNeg, kNeg}, z[2] = {0.0f, 0.0f}, ml[2], rz[2];
  float s[32], o[W / 2];
  uint32_t vis = 0;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  // walk 1: the online max and this thread's share of the sum
  auto stats = [&](auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          if (!kMasked || (vis >> i & 1u)) tmax = fmaxf(tmax, s[i]);
        }
      const float mn = fmaxf(m[hf], sm90::quad_max(tmax));
      const float mnl = mn * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          const float ex = sm90::exp2_approx(fmaf(s[i], kLog2e, -mnl));
          if (!kMasked || (vis >> i & 1u)) sum += ex;
        }
      z[hf] = z[hf] * sm90::exp2_approx((m[hf] - mn) * kLog2e) + sum;
      m[hf] = mn;
    }
  };
  // walk 2: p normalised in place
  auto probs = [&](auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      const float pv =
          sm90::exp2_approx(fmaf(s[i], kLog2e, -ml[hf])) * rz[hf];
      s[i] = (!kMasked || (vis >> i & 1u)) ? pv : 0.0f;
    }
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int step = 0; step < 2 * n; ++step) {
    issue(step + kStages - 1);
    sm90::cp_async_wait<kStages - 1>();
    sm90::fence_async_smem();
    const int st = step % kStages, kt = step < n ? step : step - n;
    const int* kv = reinterpret_cast<const int*>(cv.rows(base, st));
    // every key of the tile valid? (each thread reads the flag it copied)
    const bool full = __syncthreads_and(tid >= kTile || kv[tid] != 0);
    const bool dense = full && kt != qt;
    if (!dense) vis = visible_bits(kv, kt == qt);
    sm90::wgmma_fence();
    scores<W>(s, qs, cv.tile(base, st, 0));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    if (step < n) {
      if (dense) stats(Dense{}); else stats(Masked{});
      if (step == n - 1) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          z[hf] = sm90::quad_sum(z[hf]);
          ml[hf] = m[hf] * kLog2e;
          rz[hf] = 1.0f / fmaxf(z[hf], 1e-30f);
        }
      }
    } else {
      // p rounded into A fragments; O += T(P) V
      if (dense) probs(Dense{}); else probs(Masked{});
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::frag_a(s, kk, a[kk]);
      sm90::wgmma_fence();
      accumulate<W>(o, a, cv.tile(base, st, 1));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(o);
    }
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  store_rows<W>(o, static_cast<bf16*>(p.out) + (rowb + q0) * D + col, D, hd,
                1.0f);
  if ((tid & 3) == 0) {
    const size_t plane = (size_t)p.B * H * L;
    const size_t r = ((size_t)b * H + h) * L + q0 + acc_row(0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      p.stats[r + 8 * hf] = m[hf];
      p.stats[plane + r + 8 * hf] = z[hf];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kWg)
    flash_bwd_dq_wgmma_kernel(FlashArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const Carve<W> cv = bwd_carve<W>();
  const int D = p.D, H = p.H, hd = D / H, L = p.L, tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile, n = qt + 1;
  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const bf16* K = static_cast<const bf16*>(p.k) + col;
  const bf16* V = static_cast<const bf16*>(p.v) + col;
  bf16* qs = cv.held(base, 0);
  bf16* dos = cv.held(base, 1);
  const sm90::TileCopy<W> cp(D, hd);

  if (hd < W) sm90::zero_smem(base, cv.bytes() - 1024, kWg);
  __syncthreads();
  sm90::load_tile_sync<W>(qs, static_cast<const bf16*>(p.q) +
                                  (rowb + q0) * D + col,
                          D, kTile, hd, kWg, p.vec, p.scale, true);
  sm90::load_tile_sync<W>(dos, static_cast<const bf16*>(p.dout) +
                                   (rowb + q0) * D + col,
                          D, kTile, hd, kWg, p.vec, 1.0f, false);

  // both walks stream k, v over key tiles 0..qt
  auto issue = [&](int s) {
    if (s < 2 * n) {
      const int kt = s < n ? s : s - n, st = s % kStages;
      const size_t r0 = rowb + (size_t)kt * kTile;
      load_head_tile<W>(cp, cv.tile(base, st, 0), K + r0 * D, p, hd);
      load_head_tile<W>(cp, cv.tile(base, st, 1), V + r0 * D, p, hd);
      if (tid < kTile)
        sm90::cp_async4(reinterpret_cast<int*>(cv.rows(base, st)) + tid,
                        p.valid + r0 + tid);
    }
    sm90::cp_async_commit();
  };

  const size_t plane = (size_t)p.B * H * L;
  const size_t srow = ((size_t)b * H + h) * L + q0 + acc_row(0);
  float ml[2], rz[2], dsum[2] = {0.0f, 0.0f}, delta[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    ml[hf] = p.stats[srow + 8 * hf] * kLog2e;
    rz[hf] = 1.0f / fmaxf(p.stats[plane + srow + 8 * hf], 1e-30f);
  }
  float s[32], dp[32], dq[W / 2];
  uint32_t vis = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dq[i] = 0.0f;

  // p from the forward's stats, in place of s
  auto probs = [&](auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      const float pv =
          sm90::exp2_approx(fmaf(s[i], kLog2e, -ml[hf])) * rz[hf];
      s[i] = (!kMasked || (vis >> i & 1u)) ? pv : 0.0f;
    }
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int step = 0; step < 2 * n; ++step) {
    issue(step + kStages - 1);
    sm90::cp_async_wait<kStages - 1>();
    sm90::fence_async_smem();
    const int st = step % kStages, kt = step < n ? step : step - n;
    const int* kv = reinterpret_cast<const int*>(cv.rows(base, st));
    const bool full = __syncthreads_and(tid >= kTile || kv[tid] != 0);
    const bool dense = full && kt != qt;
    if (!dense) vis = visible_bits(kv, kt == qt);
    const bf16* ks = cv.tile(base, st, 0);
    sm90::wgmma_fence();
    scores<W>(s, qs, ks);
    scores<W>(dp, dos, cv.tile(base, st, 1));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    sm90::reg_fence(dp);
    if (dense) probs(Dense{}); else probs(Masked{});
    if (step < n) {
      // walk 1: delta = rowsum(dp * p), this thread's share
#pragma unroll
      for (int i = 0; i < 32; ++i) dsum[(i >> 1) & 1] += dp[i] * s[i];
      if (step == n - 1) {
        delta[0] = sm90::quad_sum(dsum[0]);
        delta[1] = sm90::quad_sum(dsum[1]);
      }
    } else {
      // walk 2: ds = T(p * (dp - delta)); dQ += T(ds) K
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= dp[i] - delta[(i >> 1) & 1];
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::frag_a(s, kk, a[kk]);
      sm90::wgmma_fence();
      accumulate<W>(dq, a, ks);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::reg_fence(dq);
    }
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  store_rows<W>(dq, static_cast<bf16*>(p.dq) + (rowb + q0) * D + col, D, hd,
                p.scale);
  if ((tid & 3) == 0) {
    p.delta[srow] = delta[0];
    p.delta[srow + 8] = delta[1];
  }
}

template <int W>
__global__ void __launch_bounds__(kWg)
    flash_bwd_dkdv_wgmma_kernel(FlashArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const Carve<W> cv = bwd_carve<W>();
  const int D = p.D, H = p.H, hd = D / H, L = p.L, tid = threadIdx.x;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile, n = L / kTile - kt;
  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const bf16* Q = static_cast<const bf16*>(p.q) + col;
  const bf16* DO = static_cast<const bf16*>(p.dout) + col;
  bf16* ks = cv.held(base, 0);
  bf16* vs = cv.held(base, 1);
  int* kval = reinterpret_cast<int*>(cv.held_rows(base));
  const sm90::TileCopy<W> cp(D, hd);

  if (hd < W) sm90::zero_smem(base, cv.bytes() - 1024, kWg);
  __syncthreads();
  sm90::load_tile_sync<W>(ks, static_cast<const bf16*>(p.k) +
                                  (rowb + k0) * D + col,
                          D, kTile, hd, kWg, p.vec, 1.0f, false);
  sm90::load_tile_sync<W>(vs, static_cast<const bf16*>(p.v) +
                                  (rowb + k0) * D + col,
                          D, kTile, hd, kWg, p.vec, 1.0f, false);
  if (tid < kTile) kval[tid] = p.valid[rowb + k0 + tid];

  // step s walks query tile kt + s: q (scaled after it lands), do, and the
  // query rows' max * log2(e), 1 / max(sum, 1e-30) and delta
  const size_t plane = (size_t)p.B * H * L;
  const size_t srow = ((size_t)b * H + h) * L;
  auto issue = [&](int s) {
    if (s < n) {
      const int st = s % kStages;
      const size_t q0 = (size_t)(kt + s) * kTile;
      load_head_tile<W>(cp, cv.tile(base, st, 0), Q + (rowb + q0) * D, p,
                        hd);
      load_head_tile<W>(cp, cv.tile(base, st, 1), DO + (rowb + q0) * D, p,
                        hd);
      if (tid < kTile) {
        float* rows = reinterpret_cast<float*>(cv.rows(base, st));
        sm90::cp_async4(rows + tid, p.stats + srow + q0 + tid);
        sm90::cp_async4(rows + kTile + tid, p.stats + plane + srow + q0 + tid);
        sm90::cp_async4(rows + 2 * kTile + tid, p.delta + srow + q0 + tid);
      }
    }
    sm90::cp_async_commit();
  };

  float s[32], dp[32], dk[W / 2], dv[W / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk[i] = dv[i] = 0.0f;
  __syncthreads();
  // this thread's two key rows: valid?
  const bool kv0 = kval[acc_row(0)] != 0, kv1 = kval[acc_row(2)] != 0;

  // p^T and ds^T in place of s^T and dp^T; the query rows' stats come in
  // pairs of adjacent columns
  auto grads = [&](auto masked, const float* rows, bool diag) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = acc_col(4 * j);
      const float2 mc = *reinterpret_cast<const float2*>(rows + c);
      const float2 zc = *reinterpret_cast<const float2*>(rows + kTile + c);
      const float2 dc =
          *reinterpret_cast<const float2*>(rows + 2 * kTile + c);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * j + v, e = v & 1;
        const float pv = sm90::exp2_approx(fmaf(s[i], kLog2e,
                                                -(e ? mc.y : mc.x))) *
                         (e ? zc.y : zc.x);
        const bool vis = !kMasked || (((v >> 1) ? kv1 : kv0) &&
                                      (!diag || c + e >= acc_row(i)));
        s[i] = vis ? pv : 0.0f;
        dp[i] = s[i] * (dp[i] - (e ? dc.y : dc.x));
      }
    }
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int step = 0; step < n; ++step) {
    issue(step + kStages - 1);
    sm90::cp_async_wait<kStages - 1>();
    const int st = step % kStages;
    bf16* qs = cv.tile(base, st, 0);
    const bf16* dos = cv.tile(base, st, 1);
    float* rows = reinterpret_cast<float*>(cv.rows(base, st));
    // each thread finishes what it copied itself
    if (p.vec) cp.scale(qs, p.scale);
    if (tid < kTile) {
      rows[tid] *= kLog2e;
      rows[kTile + tid] = 1.0f / fmaxf(rows[kTile + tid], 1e-30f);
    }
    if (!p.vec)   // loaded through registers: scale in place
      for (int i = tid; i < kTile * hd; i += kWg) {
        bf16* e = sm90::Tile<W>::at(qs, i / hd, i % hd, kTile);
        *e = __float2bfloat16_rn(__bfloat162float(*e) * p.scale);
      }
    sm90::fence_async_smem();
    __syncthreads();
    sm90::wgmma_fence();
    scores<W>(s, ks, qs);     // S^T: rows keys, columns queries
    scores<W>(dp, vs, dos);   // dP^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    sm90::reg_fence(dp);
    const bool diag = step == 0;
    if (kv0 && kv1 && !diag)
      grads(Dense{}, rows, diag);
    else
      grads(Masked{}, rows, diag);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::frag_a(s, kk, pa[kk]);
      sm90::frag_a(dp, kk, da[kk]);
    }
    sm90::wgmma_fence();
    accumulate<W>(dv, pa, dos);   // dV += T(p)^T dO
    accumulate<W>(dk, da, qs);    // dK += T(ds)^T Qs
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(dv);
    sm90::reg_fence(dk);
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  store_rows<W>(dk, static_cast<bf16*>(p.dk) + (rowb + k0) * D + col, D, hd,
                1.0f);
  store_rows<W>(dv, static_cast<bf16*>(p.dv) + (rowb + k0) * D + col, D, hd,
                1.0f);
}

// ===========================================================================
// launch
// ===========================================================================

bool shapes_ok(int B, int L, int D, int H) {
  if (B <= 0 || H <= 0 || L <= 0 || L % 64 != 0 || D % H != 0) return false;
  return D / H <= kMaxHd;
}

template <typename K>
int launch_wg(K kernel, size_t smem, const FlashArgs& p,
              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(p.L / kTile, p.H, p.B), kWg, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int W>
int launch_fwd_wgmma(const FlashArgs& p, cudaStream_t stream) {
  return launch_wg(flash_fwd_wgmma_kernel<W>, fwd_carve<W>().bytes(), p,
                   stream);
}

template <int W>
int launch_bwd_wgmma(const FlashArgs& p, cudaStream_t stream) {
  const size_t smem = bwd_carve<W>().bytes();
  const int e = launch_wg(flash_bwd_dq_wgmma_kernel<W>, smem, p, stream);
  if (e != 0) return e;
  return launch_wg(flash_bwd_dkdv_wgmma_kernel<W>, smem, p, stream);
}

// The first kernels' query/key tile: 64 rows, or 32 or 16 where the head
// slice would not fit shared memory at 64 (0: none fits).
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

FlashArgs make_args(const void* q, const void* k, const void* v,
                    const void* valid, void* stats, int B, int L, int D,
                    int H, float scale) {
  FlashArgs p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int*>(valid);
  p.stats = static_cast<float*>(stats);
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.scale = scale;
  p.vec = (D / H) % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v, out, dout, dq, dk, dv
// [B, L, D] head-packed in the compute dtype (bf16 when is_bf16, else
// f32), valid [B, L] int32, stats [2, B, H, L] f32 (each query row's
// softmax max and sum: written by the forward, read by the backward),
// delta [B, H, L] f32 scratch; all contiguous. Requires L % 64 == 0,
// D % H == 0 and hd = D / H at most 256. Each returns a cudaError_t code
// (0 on success).
extern "C" int flash_attn_fwd(int is_bf16, const void* q, const void* k,
                              const void* v, const void* valid, void* out,
                              void* stats, int B, int L, int D, int H,
                              float scale, void* stream) {
  if (!shapes_ok(B, L, D, H)) return (int)cudaErrorInvalidValue;
  FlashArgs p = make_args(q, k, v, valid, stats, B, L, D, H, scale);
  p.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_fwd<float>(p, s);
  switch (wgmma_width(D / H)) {
    case 16: return launch_fwd_wgmma<16>(p, s);
    case 32: return launch_fwd_wgmma<32>(p, s);
    case 64: return launch_fwd_wgmma<64>(p, s);
    case 128: return launch_fwd_wgmma<128>(p, s);
    default: return launch_fwd<bf16>(p, s);
  }
}

extern "C" int flash_attn_bwd(int is_bf16, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* valid, void* dq, void* dk, void* dv,
                              void* stats, void* delta, int B, int L, int D,
                              int H, float scale, void* stream) {
  if (!shapes_ok(B, L, D, H)) return (int)cudaErrorInvalidValue;
  FlashArgs p = make_args(q, k, v, valid, stats, B, L, D, H, scale);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = static_cast<float*>(delta);
  p.vec = p.vec && aligned16(dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_bwd<float>(p, s);
  switch (wgmma_width(D / H)) {
    case 16: return launch_bwd_wgmma<16>(p, s);
    case 32: return launch_bwd_wgmma<32>(p, s);
    case 64: return launch_bwd_wgmma<64>(p, s);
    case 128: return launch_bwd_wgmma<128>(p, s);
    default: return launch_bwd<bf16>(p, s);
  }
}
