// The HSTU attention backward (dq, dk/dv and the rel-pos gradient) for
// Hopper, sm_90a: one pair of kernels that the single-device fused backward
// (csrc/fused_block_bwd.cu, at off 0 and Lq = Lk = L), the
// sequence-parallel ring (csrc/ring_pair.cu, once per pair of shards) and
// the standalone HSTU attention (csrc/hstu_attention.cu, at off 0) launch.
//
// Replaces, in tencent_recommendation_2025_tpu/ops/fused_block.py, the
// attention half of _bwd_kernel (l.325), _bwd_dq_kernel_chunk (l.533),
// _bwd_dkdv_kernel_chunk (l.573), _pair_dq_kernel (l.1304) and
// _pair_dkdv_kernel (l.1345); in ops/hstu_attention.py, in bf16 at hd <=
// 128, _bwd_kernel (l.193), _dq_kernel_chunk (l.331) and _dkdv_kernel_chunk
// (l.380). With q [B, Lq, D] (scaled by hd^-1/2), k and
// v [B, Lk, D] (v scaled by 1/L), dav [B, Lq, D], all in the compute dtype
// T, a query at row r and a key at column c at the distance dist = r + off
// - c, per head h:
//
//   s  = q_h k_h^T + rab[h, min(dist, NB - 1)]                f32
//   a  = T(silu(s)) where dist >= 0 and the key is valid, else 0
//   da = T(dav)_h v_h^T;  ds = da dsilu(s) on the same pairs, else 0
//   dq = T(ds) k_h * dq_scale;  dk = T(ds)^T q_h;  dv = a^T T(dav)_h
//   drab[h, min(dist, NB - 1)] += ds, summed over the batch.
//
// dq_scale is hd^-1/2 on the single device (its dq feeds the projection's
// backward as the gradient of the unscaled q) and 1 on the ring (dq w.r.t.
// the scaled q). a and ds round to T only as product operands; everything
// elementwise is f32 (the TPU kernels' rounding points). Padded queries are
// not masked, as there. Every output is f32.
//
// The standalone HSTU attention (ops/hstu_attention.py) takes q and v as
// they are and rounds at its own points, which the kernels' kStandalone
// instance (template parameter) keeps: q becomes T(q * q_scale) (q_scale =
// hd^-1/2) in shared memory before any product reads it; a and ds are
// multiplied by a_mul (1/L) before they round, ds before it adds to drab;
// dq (times dq_scale = hd^-1/2), dk and dv are stored in T. T(x / L) is
// T(x) / L only where L is a power of two, so the factors go exactly where
// the plain version applies them. The other instance ignores these
// fields and compiles no extra operation, so the fused block's and the
// ring's numbers do not depend on them. The standalone attention's
// silu_qkv (kSilu, a third template parameter, off by default and only
// with kStandalone) takes the pre-activation q, k, v: q becomes T(silu(q)
// * q_scale), k and v T(silu(.)), each as its tile lands (the held tiles
// in load_tile_sync, the streamed ones by TileCopy::silu on the chunks a
// thread copied, before the ring's fence and barrier), and the stores
// multiply dq (after dq_scale), dk and dv by dsilu of the output rows'
// pre-activations, read from global memory (store_rows_dsilu).
//
// Which kernels take which shape: bf16 with hd % 8 == 0, hd <= 128 and
// both lengths multiples of 64 (every fused preset, single device or ring)
// takes the wgmma kernels; f32 (the tight check instance: Hopper has no
// full-precision f32 tensor-core product) and hd > 128 (D = 256 at H = 1)
// take the generic kernels, the ring pair kernels of PR 7 (WMMA 16x16x16
// through shared memory where hd % 16 == 0 in bf16, FMA loops otherwise).
// A choice by dtype and shape: a failed build or launch raises.
//
// The wgmma kernels (csrc/sm90_mma.cuh). One block is one warpgroup of 128
// threads and owns one 64-row tile of one (head, batch row):
//
// - attn_bwd_dq_wgmma_kernel<W>, one block per query tile, the heaviest
//   first: holds q_h and dav_h, streams k_h, v_h, the keys' valid flags and
//   the tile's 127 rel-pos biases through a two-stage cp.async ring over
//   the key tiles that hold a pair at dist >= 0; S = Q.K^T and dA =
//   dAV.V^T as SS wgmma into registers, ds in registers, dQ += T(ds).K as
//   an RS wgmma (A from registers, K as an MN-major B). 3 products a pair
//   of tiles.
// - attn_bwd_dkdv_wgmma_kernel<W>, one block per key tile: holds k_h and
//   v_h, streams q_h and dav_h; S^T = K.Q^T and dA^T = V.dAV^T directly,
//   so that T(a)^T and T(ds)^T are register A operands of dV += T(a)^T.dAV
//   and dK += T(ds)^T.Q. 4 products a pair.
//
// W is hd padded to 16, 32, 64 or 128 columns with zeros in shared memory;
// kStandalone selects the standalone attention's rounding points and bf16
// outputs (above).
// Tiles whose pairs all lie in the future are skipped; a tile whose pairs
// are all visible (every key valid, every distance >= 0) takes an
// elementwise path with no mask. The sigmoid runs on the special-function
// unit (ex2.approx, rcp.approx).
//
// The rel-pos gradient, in the dq kernel: a tile whose smallest distance
// is at least NB - 1 adds its ds to this thread's sum of the clamped bucket
// (most tiles at long L); a tile near the diagonal writes its f32 ds to
// shared memory (the clamped pairs go to that sum instead), and 127 threads
// sum its diagonals in a fixed order into the block's [NB] partial, each
// diagonal one distance. At the end the threads' clamped sums add in a
// fixed order; the block writes its partial to row (batch row, query tile)
// of part_rab, and reduce_rows_split_kernel sums the rows in order. No atomics:
// the result is deterministic.
//
// Bound on the H100 at the flagship shape (B=128, L=1024, D=64, H=1): the
// least work is 5 causal products (s, da, dv, dk, dq), 42.99 GFLOP, 0.043
// ms at 989 TFLOP/s bf16, against q, k, v, dav in bf16 and dq, dk, dv in
// f32, 168.3 MB (0.050 ms at 3.35 TB/s): bound by bytes, barely. The two
// kernels run 7 products (s and da in both).
#pragma once

#include "fused_block_common.cuh"
#include "sm90_mma.cuh"

namespace hstu_bwd {

using fbk::bf16;

// The backward's arguments, built by each caller from its own.
struct AttnBwdArgs {
  const void* q;     // [B, Lq, D] T, scaled by hd^-1/2 (standalone: not)
  const void* k;     // [B, Lk, D] T
  const void* v;     // [B, Lk, D] T, scaled by 1/L (standalone: not)
  const void* dav;   // [B, Lq, D] T
  const int* valid;  // [B, Lk] nonzero = valid key
  const float* rab;  // [H, NB]
  void* dq;          // [B, Lq, D] f32 (standalone: T), times dq_scale
  void* dk;          // [B, Lk, D] f32 (standalone: T)
  void* dv;          // [B, Lk, D] f32 (standalone: T), w.r.t. the v taken
  float* part_rab;   // [B * Lq / 16, H * NB]: per-(query tile, row) partials
  float* drab;       // [H, NB]
  int B, Lq, Lk, D, H, NB;
  int off;           // first query position minus first key position
  float dq_scale;
  float q_scale;     // standalone: q rounds to T(q * q_scale) first
  float a_mul;       // standalone: a and ds times a_mul before rounding
};

// ===========================================================================
// The generic kernels: f32, and bf16 where the wgmma kernels do not apply
// ===========================================================================

using fbk::align128;
using fbk::from_f;
using fbk::gemm;
using fbk::kLdP;
using fbk::kLdS;
using fbk::kThreads;
using fbk::load_tile;

template <typename T>
inline size_t generic_smem(int D, int TT, int HNB) {
  const size_t tile = align128((size_t)TT * (D + 8) * sizeof(T));
  return 4 * tile                                            // q, k, v, dot_b
         + 2 * align128((size_t)TT * kLdS * sizeof(float))   // s, da / ds
         + 2 * align128((size_t)TT * kLdP * sizeof(T))       // T(a), T(ds)
         + 2 * align128((size_t)TT * (D + 4) * sizeof(float))  // accumulators
         + align128(TT * sizeof(int))                        // key valid
         + align128(HNB * sizeof(float))                     // rel-pos grads
         + align128(2 * TT * sizeof(float));                 // diagonal sums
}

// dq and the rel-pos gradient: one query tile walks the key tiles that hold
// a pair at distance >= 0; the rel-pos sums of its pairs, per diagonal of
// each tile, go to its own row of part_rab.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(AttnBwdArgs p, int TT, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, H = p.H, hd = D / H, NB = p.NB;
  const int ldt = D + 8, ldf = D + 4;
  const int b = blockIdx.y, qt = blockIdx.x, q0 = qt * TT;
  const bool tc_attn = tc && (hd % 16 == 0);

  unsigned char* ptr = smem;
  const size_t tile = align128((size_t)TT * ldt * sizeof(T));
  T* qs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* ks = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* vs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* dbs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  float* ss = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * kLdS * sizeof(float));
  float* das = reinterpret_cast<float*>(ptr);  // da, then ds
  ptr += align128((size_t)TT * kLdS * sizeof(float));
  T* dss = reinterpret_cast<T*>(ptr);
  ptr += 2 * align128((size_t)TT * kLdP * sizeof(T));
  float* dq = reinterpret_cast<float*>(ptr);
  ptr += 2 * align128((size_t)TT * ldf * sizeof(float));
  int* kval = reinterpret_cast<int*>(ptr);
  ptr += align128(TT * sizeof(int));
  float* drab = reinterpret_cast<float*>(ptr);
  ptr += align128(H * NB * sizeof(float));
  float* diag = reinterpret_cast<float*>(ptr);

  const size_t rowq = (size_t)b * p.Lq + q0;
  load_tile<T>(static_cast<const T*>(p.q) + rowq * D, TT, D, qs, ldt);
  load_tile<T>(static_cast<const T*>(p.dav) + rowq * D, TT, D, dbs, ldt);
  for (int i = threadIdx.x; i < TT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dq[r * ldf + d] = 0.0f;
  }
  for (int i = threadIdx.x; i < H * NB; i += kThreads) drab[i] = 0.0f;

  const int last = q0 + TT - 1 + p.off;
  const size_t rowk = (size_t)b * p.Lk;
  for (int k0 = 0; k0 < p.Lk && k0 <= last; k0 += TT) {
    __syncthreads();  // the previous key tile is done with ks/vs/dss
    load_tile<T>(static_cast<const T*>(p.k) + (rowk + k0) * D, TT, D, ks,
                 ldt);
    load_tile<T>(static_cast<const T*>(p.v) + (rowk + k0) * D, TT, D, vs,
                 ldt);
    for (int j = threadIdx.x; j < TT; j += kThreads)
      kval[j] = p.valid[rowk + k0 + j];
    __syncthreads();
    const int base = q0 + p.off - k0;  // distance of the tile's (0, 0) pair
    for (int h = 0; h < H; ++h) {
      const float* rab = p.rab + (size_t)h * NB;
      gemm<T, false, true, false>(qs + h * hd, ldt, ks + h * hd, ldt, ss,
                                  kLdS, TT, TT, hd, tc_attn);
      gemm<T, false, true, false>(dbs + h * hd, ldt, vs + h * hd, ldt, das,
                                  kLdS, TT, TT, hd, tc_attn);
      __syncthreads();
      for (int i = threadIdx.x; i < TT * TT; i += kThreads) {
        const int r = i / TT, c = i - r * TT;
        const int dist = base + r - c;
        float ds = 0.0f;
        if (dist >= 0 && kval[c] != 0)
          ds = das[r * kLdS + c] *
               fbk::dsilu(ss[r * kLdS + c] + rab[min(dist, NB - 1)]);
        das[r * kLdS + c] = ds;
        dss[r * kLdP + c] = from_f<T>(ds);
      }
      __syncthreads();
      // dq += T(ds) k
      gemm<T, false, false, true>(dss, kLdP, ks + h * hd, ldt, dq + h * hd,
                                  ldf, TT, hd, TT, tc_attn);
      // rel-pos gradient: diagonal e (r - c = e - (TT - 1)) holds the pairs
      // at distance base + e - (TT - 1); distances below NB - 1 are
      // distinct per diagonal, the clamped ones fold in order below
      for (int e = threadIdx.x; e < 2 * TT - 1; e += kThreads) {
        const int de = e - (TT - 1);
        float s = 0.0f;
        for (int r = max(0, de); r < min(TT, TT + de); ++r)
          s += das[r * kLdS + (r - de)];
        diag[e] = s;
        const int dist = base + de;
        if (dist >= 0 && dist < NB - 1) drab[h * NB + dist] += s;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int e = 0; e < 2 * TT - 1; ++e)
          if (base + e - (TT - 1) >= NB - 1) drab[h * NB + NB - 1] += diag[e];
      }
      __syncthreads();
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < TT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    static_cast<float*>(p.dq)[(rowq + r) * D + d] =
        dq[r * ldf + d] * p.dq_scale;
  }
  float* out = p.part_rab + ((size_t)b * gridDim.x + qt) * H * NB;
  for (int i = threadIdx.x; i < H * NB; i += kThreads) out[i] = drab[i];
}

// dk and dv: one key tile walks the query tiles that hold a pair at
// distance >= 0 with it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(AttnBwdArgs p, int TT, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, H = p.H, hd = D / H, NB = p.NB;
  const int ldt = D + 8, ldf = D + 4;
  const int b = blockIdx.y, k0 = blockIdx.x * TT;
  const bool tc_attn = tc && (hd % 16 == 0);

  unsigned char* ptr = smem;
  const size_t tile = align128((size_t)TT * ldt * sizeof(T));
  T* qs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* ks = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* vs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  T* dbs = reinterpret_cast<T*>(ptr);
  ptr += tile;
  float* ss = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * kLdS * sizeof(float));
  float* das = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * kLdS * sizeof(float));
  T* ps = reinterpret_cast<T*>(ptr);  // T(a)
  ptr += align128((size_t)TT * kLdP * sizeof(T));
  T* dss = reinterpret_cast<T*>(ptr);  // T(ds)
  ptr += align128((size_t)TT * kLdP * sizeof(T));
  float* dk = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * ldf * sizeof(float));
  float* dv = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * ldf * sizeof(float));
  int* kval = reinterpret_cast<int*>(ptr);

  const size_t rowk = (size_t)b * p.Lk + k0;
  load_tile<T>(static_cast<const T*>(p.k) + rowk * D, TT, D, ks, ldt);
  load_tile<T>(static_cast<const T*>(p.v) + rowk * D, TT, D, vs, ldt);
  for (int j = threadIdx.x; j < TT; j += kThreads) kval[j] = p.valid[rowk + j];
  for (int i = threadIdx.x; i < TT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dk[r * ldf + d] = 0.0f;
    dv[r * ldf + d] = 0.0f;
  }

  const size_t rowb = (size_t)b * p.Lq;
  for (int q0 = 0; q0 < p.Lq; q0 += TT) {
    if (q0 + TT - 1 + p.off < k0) continue;  // every pair in the future
    __syncthreads();  // the previous query tile is done with qs/dbs
    load_tile<T>(static_cast<const T*>(p.q) + (rowb + q0) * D, TT, D, qs,
                 ldt);
    load_tile<T>(static_cast<const T*>(p.dav) + (rowb + q0) * D, TT, D, dbs,
                 ldt);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      const float* rab = p.rab + (size_t)h * NB;
      gemm<T, false, true, false>(qs + h * hd, ldt, ks + h * hd, ldt, ss,
                                  kLdS, TT, TT, hd, tc_attn);
      gemm<T, false, true, false>(dbs + h * hd, ldt, vs + h * hd, ldt, das,
                                  kLdS, TT, TT, hd, tc_attn);
      __syncthreads();
      for (int i = threadIdx.x; i < TT * TT; i += kThreads) {
        const int r = i / TT, c = i - r * TT;
        const int dist = (q0 + r + p.off) - (k0 + c);
        float a = 0.0f, ds = 0.0f;
        if (dist >= 0 && kval[c] != 0) {
          const float s = ss[r * kLdS + c] + rab[min(dist, NB - 1)];
          a = fbk::silu(s);
          ds = das[r * kLdS + c] * fbk::dsilu(s);
        }
        ps[r * kLdP + c] = from_f<T>(a);
        dss[r * kLdP + c] = from_f<T>(ds);
      }
      __syncthreads();
      // dv += T(a)^T dot_b;  dk += T(ds)^T q
      gemm<T, true, false, true>(ps, kLdP, dbs + h * hd, ldt, dv + h * hd,
                                 ldf, TT, hd, TT, tc_attn);
      gemm<T, true, false, true>(dss, kLdP, qs + h * hd, ldt, dk + h * hd,
                                 ldf, TT, hd, TT, tc_attn);
      __syncthreads();
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < TT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    static_cast<float*>(p.dk)[(rowk + r) * D + d] = dk[r * ldf + d];
    static_cast<float*>(p.dv)[(rowk + r) * D + d] = dv[r * ldf + d];
  }
}

// Widest tile (64, 32 or 16 rows) dividing both lengths whose shared memory
// fits; 0 if none.
template <typename T>
inline int generic_tile(const AttnBwdArgs& p) {
  for (int t = 64; t >= 16; t >>= 1)
    if (p.Lq % t == 0 && p.Lk % t == 0 &&
        generic_smem<T>(p.D, t, p.H * p.NB) <= fbk::kMaxSmem)
      return t;
  return 0;
}

// ===========================================================================
// The wgmma kernels: bf16, hd <= 128 padded to W columns
// ===========================================================================

constexpr int kTile = sm90::kRows;   // query and key tile rows
constexpr int kWg = sm90::kWgThreads;
constexpr int kDiags = 2 * kTile - 1;  // diagonals of a tile pair
constexpr int kDsLd = kTile + 8;     // row stride of the f32 ds tile

using sm90::acc_col;
using sm90::acc_row;
using sm90::aligned16;
using sm90::Carve;
using sm90::kLog2e;
using sm90::kStages;
using sm90::wgmma_width;

// 1 / x by the special-function unit (rcp.approx.ftz: 1 ulp; 0 at inf)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// silu(v) and dsilu(v) = sig (1 + v (1 - sig)), sig = 1 / (1 + e^-v)
__device__ __forceinline__ void silu_pair(float v, float& a, float& g) {
  const float sg = rcp_approx(1.0f + sm90::exp2_approx(-v * kLog2e));
  a = v * sg;
  g = sg * (1.0f + v * (1.0f - sg));
}

__host__ __device__ inline size_t round1024(size_t n) {
  return (n + 1023) & ~size_t(1023);
}

// dq kernel: q, dav held with the ds tile, the [NB] partial and 4 floats
// of the warps' clamped sums; k, v per stage (and the keys' valid flags and
// the tile's rel-pos biases in its row data)
template <int W>
__host__ __device__ inline Carve<W> dq_carve(int NB) {
  return Carve<W>{2, 2,
                  round1024(kTile * kDsLd * sizeof(float) +
                            ((size_t)NB + 4) * sizeof(float))};
}

// dk/dv kernel: k, v held with the key-valid flags; q, dav per stage (and
// the tile's rel-pos biases in its row data)
template <int W>
__host__ __device__ inline Carve<W> dkdv_carve() {
  return Carve<W>{2, 2};
}

// Writes this thread's part of a 64 x W f32 accumulator, times `scale`, to
// rows of `out` (row stride D), the first hd columns (hd even): f32 pairs,
// or pairs rounded to bf16.
__device__ __forceinline__ void store_pair(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

template <int W, typename O>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2], O* out,
                                           int D, int hd, float scale) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int r = acc_row(i), c = acc_col(i);
    if (c < hd)
      store_pair(out + (size_t)r * D + c, acc[i] * scale, acc[i + 1] * scale);
  }
}

// store_rows of the standalone attention's silu_qkv instance: each value
// times `scale`, then times dsilu (f32) of the pre-activation at the same
// place of `pre` (the output rows of q, k or v, row stride D), rounded to
// bf16 once.
template <int W>
__device__ __forceinline__ void store_rows_dsilu(const float (&acc)[W / 2],
                                                 bf16* out, const bf16* pre,
                                                 int D, int hd, float scale) {
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int r = acc_row(i), c = acc_col(i);
    if (c < hd) {
      const bf16* x = pre + (size_t)r * D + c;
      store_pair(out + (size_t)r * D + c,
                 acc[i] * scale * fbk::dsilu(__bfloat162float(x[0])),
                 acc[i + 1] * scale * fbk::dsilu(__bfloat162float(x[1])));
    }
  }
}

// The instance's output type: T (bf16) for the standalone attention, f32
// for the fused block and the ring.
template <bool kStandalone>
using BwdOut = typename std::conditional<kStandalone, bf16, float>::type;

// x * m in the standalone instance (a and ds times 1/L before they round);
// x itself in the other, which compiles no multiply by 1.
template <bool kStandalone>
__device__ __forceinline__ float own_mul(float x, float m) {
  if constexpr (kStandalone)
    return x * m;
  else
    return x;
}

// The elementwise steps run in two instances: `masked` tests each pair's
// distance and key; the other serves tiles whose pairs are all visible.
using Masked = std::true_type;
using Dense = std::false_type;

template <int W, bool kStandalone, bool kSilu = false>
__global__ void __launch_bounds__(kWg)
    attn_bwd_dq_wgmma_kernel(AttnBwdArgs p) {
  static_assert(kStandalone || !kSilu, "silu_qkv is the standalone's");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const Carve<W> cv = dq_carve<W>(p.NB);
  const int D = p.D, H = p.H, hd = D / H, NB = p.NB, tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const size_t col = (size_t)h * hd;
  // key tiles 0 .. n - 1 hold a pair at distance >= 0
  const int last = q0 + kTile - 1 + p.off;
  const int n = last < 0 ? 0 : min(p.Lk / kTile, last / kTile + 1);
  const bf16* K = static_cast<const bf16*>(p.k) + col;
  const bf16* V = static_cast<const bf16*>(p.v) + col;
  const float* rab = p.rab + (size_t)h * NB;
  bf16* qs = cv.held(base, 0);
  bf16* dbs = cv.held(base, 1);
  float* dsm = reinterpret_cast<float*>(cv.held_rows(base));  // [64][kDsLd]
  float* drab = dsm + kTile * kDsLd;                          // [NB]
  float* red = drab + NB;                                     // [4]
  const sm90::TileCopy<W> cp(D, hd);

  // the loads never write the padding columns hd..W-1: zero them once
  if (hd < W) sm90::zero_smem(base, cv.bytes() - 1024, kWg);
  __syncthreads();
  for (int j = tid; j < NB; j += kWg) drab[j] = 0.0f;
  const size_t rowq = (size_t)b * p.Lq + q0;
  // the standalone instance rounds T(q * q_scale) here, before any product
  // (the silu_qkv instance T(silu(q) * q_scale))
  sm90::load_tile_sync<W, kSilu>(
      qs, static_cast<const bf16*>(p.q) + rowq * D + col, D, kTile, hd, kWg,
      true, kStandalone ? p.q_scale : 1.0f, kStandalone);
  sm90::load_tile_sync<W>(dbs,
                          static_cast<const bf16*>(p.dav) + rowq * D + col, D,
                          kTile, hd, kWg, true, 1.0f, false);

  // step s streams key tile s: k, v, its keys' valid flags and the biases
  // of its 127 diagonals (diagonal e = r - c + 63 at distance base + e - 63)
  auto issue = [&](int s) {
    if (s < n) {
      const int st = s % kStages;
      const size_t r0 = (size_t)b * p.Lk + (size_t)s * kTile;
      cp.async(cv.tile(base, st, 0), K + r0 * D);
      cp.async(cv.tile(base, st, 1), V + r0 * D);
      unsigned char* rows = cv.rows(base, st);
      if (tid < kTile)
        sm90::cp_async4(reinterpret_cast<int*>(rows) + tid,
                        p.valid + r0 + tid);
      if (tid < kDiags) {
        const int dist = q0 + p.off - s * kTile + tid - (kTile - 1);
        sm90::cp_async4(reinterpret_cast<float*>(rows + 256) + tid,
                        rab + min(max(dist, 0), NB - 1));
      }
    }
    sm90::cp_async_commit();
  };

  float s[32], da[32], dq[W / 2];
  float far = 0.0f;   // this thread's share of the clamped bucket NB - 1
  const float a_mul = p.a_mul;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = da[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dq[i] = 0.0f;
  const int r0 = acc_row(0), c0 = acc_col(0);

  // ds in place of da (rows queries, columns keys)
  auto grads = [&](auto masked, const int* kv, const float* rw, int based) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r0 + (((i >> 1) & 1) << 3);
      const int c = c0 + ((i >> 2) << 3) + (i & 1);
      float a, g;
      silu_pair(s[i] + rw[r - c + kTile - 1], a, g);
      const bool vis = !kMasked || (based + r - c >= 0 && kv[c] != 0);
      da[i] = vis ? own_mul<kStandalone>(da[i] * g, a_mul) : 0.0f;
    }
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int step = 0; step < n; ++step) {
    issue(step + kStages - 1);
    sm90::cp_async_wait<kStages - 1>();
    const int st = step % kStages;
    if constexpr (kSilu) {   // T(silu(k)), T(silu(v)) on this thread's chunks
      cp.silu(cv.tile(base, st, 0), 1.0f);
      cp.silu(cv.tile(base, st, 1), 1.0f);
    }
    sm90::fence_async_smem();
    const unsigned char* rows = cv.rows(base, st);
    const int* kv = reinterpret_cast<const int*>(rows);
    const float* rw = reinterpret_cast<const float*>(rows + 256);
    // every key of the tile valid? (each thread reads the flag it copied)
    const bool full = __syncthreads_and(tid >= kTile || kv[tid] != 0);
    const int based = q0 + p.off - step * kTile;  // distance of pair (0, 0)
    const bf16* ks = cv.tile(base, st, 0);
    sm90::wgmma_fence();
    sm90::scores<W>(s, qs, ks);
    sm90::scores<W>(da, dbs, cv.tile(base, st, 1));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    sm90::reg_fence(da);
    if (full && based - (kTile - 1) >= 0)
      grads(Dense{}, kv, rw, based);
    else
      grads(Masked{}, kv, rw, based);
    // dQ += T(ds) K, in flight while the rel-pos sums run
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::frag_a(da, kk, a[kk]);
    sm90::wgmma_fence();
    sm90::accumulate<W>(dq, a, ks);
    sm90::wgmma_commit();
    if (based - (kTile - 1) >= NB - 1) {
      // every pair in the clamped bucket
#pragma unroll
      for (int i = 0; i < 32; ++i) far += da[i];
    } else {
      // the clamped pairs to this thread's sum, the rest to the ds tile
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = r0 + (((i >> 1) & 1) << 3);
        const int c = c0 + ((i >> 2) << 3);
        const bool c0c = based + r - c >= NB - 1;
        const bool c1c = based + r - c - 1 >= NB - 1;
        far += (c0c ? da[i] : 0.0f) + (c1c ? da[i + 1] : 0.0f);
        *reinterpret_cast<float2*>(dsm + r * kDsLd + c) =
            make_float2(c0c ? 0.0f : da[i], c1c ? 0.0f : da[i + 1]);
      }
      __syncthreads();
      // diagonal e (r - c = e - 63) is distance based + e - 63: one bucket
      if (tid < kDiags) {
        const int de = tid - (kTile - 1), dist = based + de;
        if (dist >= 0 && dist < NB - 1) {
          float sum = 0.0f;
#pragma unroll 8
          for (int r = 0; r < kTile; ++r) {
            const int c = r - de;
            if (c >= 0 && c < kTile) sum += dsm[r * kDsLd + c];
          }
          drab[dist] += sum;
        }
      }
    }
    sm90::wgmma_wait<0>();
    sm90::reg_fence(dq);
    __syncthreads();  // this stage and the ds tile are read
  }
  using O = BwdOut<kStandalone>;
  if constexpr (kSilu)   // the pre-activation q's gradient
    store_rows_dsilu<W>(dq, static_cast<bf16*>(p.dq) + rowq * D + col,
                        static_cast<const bf16*>(p.q) + rowq * D + col, D,
                        hd, p.dq_scale);
  else
    store_rows<W>(dq, static_cast<O*>(p.dq) + rowq * D + col, D, hd,
                  p.dq_scale);

  // the clamped bucket: the threads' sums in a fixed order
  far = fbk::warp_sum(far);
  if ((tid & 31) == 0) red[tid >> 5] = far;
  __syncthreads();
  if (tid == 0) drab[NB - 1] += (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();
  float* out = p.part_rab + ((size_t)b * gridDim.x + qt) * H * NB +
               (size_t)h * NB;
  for (int j = tid; j < NB; j += kWg) out[j] = drab[j];
}

template <int W, bool kStandalone, bool kSilu = false>
__global__ void __launch_bounds__(kWg)
    attn_bwd_dkdv_wgmma_kernel(AttnBwdArgs p) {
  static_assert(kStandalone || !kSilu, "silu_qkv is the standalone's");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const Carve<W> cv = dkdv_carve<W>();
  const int D = p.D, H = p.H, hd = D / H, NB = p.NB, tid = threadIdx.x;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const size_t col = (size_t)h * hd;
  // query tiles first .. Lq / 64 - 1 hold a pair at distance >= 0
  const int need = k0 - p.off - (kTile - 1);  // least first query position
  const int first = need > 0 ? (need + kTile - 1) / kTile : 0;
  const int n = max(0, p.Lq / kTile - first);
  const bf16* Q = static_cast<const bf16*>(p.q) + col;
  const bf16* DAV = static_cast<const bf16*>(p.dav) + col;
  const float* rab = p.rab + (size_t)h * NB;
  bf16* ks = cv.held(base, 0);
  bf16* vs = cv.held(base, 1);
  int* kval = reinterpret_cast<int*>(cv.held_rows(base));
  const sm90::TileCopy<W> cp(D, hd);

  if (hd < W) sm90::zero_smem(base, cv.bytes() - 1024, kWg);
  __syncthreads();
  const size_t rowk = (size_t)b * p.Lk + k0;
  // (the silu_qkv instance: T(silu(k)), T(silu(v)))
  sm90::load_tile_sync<W, kSilu>(
      ks, static_cast<const bf16*>(p.k) + rowk * D + col, D, kTile, hd, kWg,
      true, 1.0f, false);
  sm90::load_tile_sync<W, kSilu>(
      vs, static_cast<const bf16*>(p.v) + rowk * D + col, D, kTile, hd, kWg,
      true, 1.0f, false);
  if (tid < kTile) kval[tid] = p.valid[rowk + tid];

  // step s streams query tile first + s: q, dav and the biases of its 127
  // diagonals (diagonal e = c - r + 63 at distance base + e - 63)
  auto issue = [&](int s) {
    if (s < n) {
      const int st = s % kStages;
      const int q0 = (first + s) * kTile;
      const size_t r0 = (size_t)b * p.Lq + q0;
      cp.async(cv.tile(base, st, 0), Q + r0 * D);
      cp.async(cv.tile(base, st, 1), DAV + r0 * D);
      if (tid < kDiags) {
        const int dist = q0 + p.off - k0 + tid - (kTile - 1);
        sm90::cp_async4(reinterpret_cast<float*>(cv.rows(base, st)) + tid,
                        rab + min(max(dist, 0), NB - 1));
      }
    }
    sm90::cp_async_commit();
  };

  float s[32], da[32], dk[W / 2], dv[W / 2];
  const float a_mul = p.a_mul;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = da[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk[i] = dv[i] = 0.0f;
  __syncthreads();
  // this thread's two key rows: valid?
  const int r0 = acc_row(0), c0 = acc_col(0);
  const bool kv0 = kval[r0] != 0, kv1 = kval[r0 + 8] != 0;

  // a^T and ds^T in place of s^T and da^T (rows keys, columns queries)
  auto grads = [&](auto masked, const float* rw, int based) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r0 + (((i >> 1) & 1) << 3);
      const int c = c0 + ((i >> 2) << 3) + (i & 1);
      float a, g;
      silu_pair(s[i] + rw[c - r + kTile - 1], a, g);
      const bool vis = !kMasked || (based + c - r >= 0 &&
                                    ((i >> 1) & 1 ? kv1 : kv0));
      s[i] = vis ? own_mul<kStandalone>(a, a_mul) : 0.0f;
      da[i] = vis ? own_mul<kStandalone>(da[i] * g, a_mul) : 0.0f;
    }
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int step = 0; step < n; ++step) {
    issue(step + kStages - 1);
    sm90::cp_async_wait<kStages - 1>();
    const int st = step % kStages;
    // the standalone instance: T(q * q_scale) on the chunks this thread
    // copied, before the fence and the barrier (silu_qkv: T(silu(q) *
    // q_scale))
    if constexpr (kSilu)
      cp.silu(cv.tile(base, st, 0), p.q_scale);
    else if constexpr (kStandalone)
      cp.scale(cv.tile(base, st, 0), p.q_scale);
    sm90::fence_async_smem();
    __syncthreads();
    const bf16* qs = cv.tile(base, st, 0);
    const bf16* dbs = cv.tile(base, st, 1);
    const float* rw = reinterpret_cast<const float*>(cv.rows(base, st));
    const int based = (first + step) * kTile + p.off - k0;  // pair (0, 0)
    sm90::wgmma_fence();
    sm90::scores<W>(s, ks, qs);     // S^T: rows keys, columns queries
    sm90::scores<W>(da, vs, dbs);   // dA^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(s);
    sm90::reg_fence(da);
    if (kv0 && kv1 && based - (kTile - 1) >= 0)
      grads(Dense{}, rw, based);
    else
      grads(Masked{}, rw, based);
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::frag_a(s, kk, pa[kk]);
      sm90::frag_a(da, kk, dsa[kk]);
    }
    sm90::wgmma_fence();
    sm90::accumulate<W>(dv, pa, dbs);   // dV += T(a)^T dAV
    sm90::accumulate<W>(dk, dsa, qs);   // dK += T(ds)^T Q
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(dv);
    sm90::reg_fence(dk);
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  using O = BwdOut<kStandalone>;
  if constexpr (kSilu) {   // the pre-activation k's and v's gradients
    store_rows_dsilu<W>(dk, static_cast<bf16*>(p.dk) + rowk * D + col,
                        static_cast<const bf16*>(p.k) + rowk * D + col, D,
                        hd, 1.0f);
    store_rows_dsilu<W>(dv, static_cast<bf16*>(p.dv) + rowk * D + col,
                        static_cast<const bf16*>(p.v) + rowk * D + col, D,
                        hd, 1.0f);
  } else {
    store_rows<W>(dk, static_cast<O*>(p.dk) + rowk * D + col, D, hd, 1.0f);
    store_rows<W>(dv, static_cast<O*>(p.dv) + rowk * D + col, D, hd, 1.0f);
  }
}

// ===========================================================================
// launch
// ===========================================================================

// Whether bf16 operands of this shape take the wgmma kernels: head slices
// in whole 16-byte chunks on 16-byte boundaries, at most 128 wide, and
// both lengths in whole 64-row tiles.
inline bool wgmma_shape(const AttnBwdArgs& p) {
  const int hd = p.D / p.H;
  return hd % 8 == 0 && wgmma_width(hd) != 0 && p.Lq % kTile == 0 &&
         p.Lk % kTile == 0 && aligned16(p.q) && aligned16(p.k) &&
         aligned16(p.v) && aligned16(p.dav);
}

// Sets `kernel`'s shared memory, launches it and returns the launch error.
template <typename K, typename... Args>
inline int launch_kernel(K kernel, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, Args... args) {
  if (smem > fbk::kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// part_rab's rows of per-(query tile, row) partials (B * Lq / tile of
// them, up to thousands), summed in a fixed order
inline int reduce_rab(const AttnBwdArgs& p, int tile, cudaStream_t stream) {
  const int hnb = p.H * p.NB;
  fbk::reduce_rows_split_kernel<<<(hnb + 31) / 32, dim3(32, fbk::kSplitRows),
                                  0, stream>>>(
      p.part_rab, p.B * (p.Lq / tile), hnb, p.drab);
  return (int)cudaGetLastError();
}

template <int W, bool kStandalone, bool kSilu = false>
inline int launch_wgmma(const AttnBwdArgs& p, bool dq, bool dkdv,
                        cudaStream_t stream) {
  if (dq) {
    const int e = launch_kernel(
        attn_bwd_dq_wgmma_kernel<W, kStandalone, kSilu>,
        dim3(p.Lq / kTile, p.H, p.B), kWg, dq_carve<W>(p.NB).bytes(), stream,
        p);
    if (e != 0) return e;
    const int e2 = reduce_rab(p, kTile, stream);
    if (e2 != 0) return e2;
  }
  if (dkdv)
    return launch_kernel(attn_bwd_dkdv_wgmma_kernel<W, kStandalone, kSilu>,
                         dim3(p.Lk / kTile, p.H, p.B), kWg,
                         dkdv_carve<W>().bytes(), stream, p);
  return 0;
}

// dq (with drab) and/or dk/dv of ``p``: the wgmma kernels for bf16 where
// wgmma_shape holds, else the generic ones. Returns a cudaError_t code.
template <typename T>
inline int launch(const AttnBwdArgs& p, bool dq, bool dkdv,
                  cudaStream_t stream) {
  if (p.Lq % 16 != 0 || p.Lk % 16 != 0 || p.D % 16 != 0 || p.H <= 0 ||
      p.D % p.H != 0 || p.NB <= 0 || p.B <= 0)
    return (int)cudaErrorInvalidValue;
  if (std::is_same<T, bf16>::value && wgmma_shape(p)) {
    switch (wgmma_width(p.D / p.H)) {
      case 16: return launch_wgmma<16, false>(p, dq, dkdv, stream);
      case 32: return launch_wgmma<32, false>(p, dq, dkdv, stream);
      case 64: return launch_wgmma<64, false>(p, dq, dkdv, stream);
      default: return launch_wgmma<128, false>(p, dq, dkdv, stream);
    }
  }
  const int TT = generic_tile<T>(p);
  if (TT == 0) return (int)cudaErrorInvalidValue;
  const bool tc = std::is_same<T, bf16>::value;
  const size_t sm = generic_smem<T>(p.D, TT, p.H * p.NB);
  if (dq) {
    int e = launch_kernel(attn_bwd_dq_kernel<T>, dim3(p.Lq / TT, p.B),
                          kThreads, sm, stream, p, TT, tc);
    if (e != 0) return e;
    if ((e = reduce_rab(p, TT, stream)) != 0) return e;
  }
  if (dkdv)
    return launch_kernel(attn_bwd_dkdv_kernel<T>, dim3(p.Lk / TT, p.B),
                         kThreads, sm, stream, p, TT, tc);
  return 0;
}

}  // namespace hstu_bwd
