// Standalone HSTU pointwise attention for Hopper, sm_90a: forward and
// backward, whole sequence and chunked over keys.
//
// Replaces tencent_recommendation_2025_tpu/ops/hstu_attention.py::
// _fwd_kernel (l.164) and _fwd_kernel_chunk (l.297) with
// hstu_fwd_wgmma_kernel (bf16, hd <= 128) or hstu_fwd_kernel, and
// ::_bwd_kernel (l.193), _dq_kernel_chunk (l.331) and _dkdv_kernel_chunk
// (l.380) with attn_bwd_dq_wgmma_kernel, attn_bwd_dkdv_wgmma_kernel and
// reduce_rows_split_kernel (csrc/hstu_attn_bwd_sm90.cuh, bf16, hd <= 128)
// or hstu_bwd_dq_kernel, hstu_bwd_dkdv_kernel and reduce_rows_kernel. Per
// batch row and head h, with q, k, v, dout
// [B, L, D] head-packed (D = H * hd, post-SiLU) in the compute dtype T
// (bf16 on the product path, f32 in the checks) and rab [H, NB] f32:
//
//   qs = T(q_h * hd^-1/2)                        (rounded before q.k^T)
//   s  = qs k_h^T + rab[h, min(q - k, NB - 1)]   f32
//   a  = T(silu(s) * (causal & key valid) * (1/L))  (L the padded length)
//   out_h = a v_h                                f32 accumulation, out in T
//
//   backward: dv = a^T do; da = do v^T; ds = da * dsilu(s) * mask / L (f32);
//   dq = T(ds) k * hd^-1/2; dk = T(ds)^T qs; drab[h, bucket] = sum of ds
//   over the pairs in that bucket, every batch row. dq, dk, dv in T, drab
//   in f32.
//
// These are the TPU kernels' rounding points, the same in the whole-sequence
// kernels and in the chunked ones (which take over past L * max(D, 64) =
// 1024 * 64 on the TPU, where a whole [L, D] row no longer fits its VMEM).
// The TPU kernels build rab into [blk, blk] bias tiles (one per
// sub-diagonal block offset below n_near, then one constant far tile; blk
// 128, or 256 in the chunked kernels) and return their gradients, which
// _bias_tiles_transpose folds back to rab. Here the bias is read from rab
// by distance, which gives the same values at either blk (every distance of
// a far tile clamps to NB - 1), and the gradient is summed straight into
// rab's buckets per tile diagonal.
//
// Design. The TPU's whole-sequence kernel runs a grid of (B,) over one
// row's whole [L, D] in VMEM; its chunked kernels stream [blk, D] key tiles
// on a (B, nq, nk) grid with an f32 accumulator carried across the key
// axis. Here every kernel streams key (or query) tiles through shared
// memory at any L, so one design serves both routes, which differ only in
// their launch counts (ops/hstu_attention.py). Two designs, chosen by
// hstu_wgmma_route (below):
//
// - bf16 with head slices in whole 16-byte chunks at most 128 wide (every
//   HSTU preset, hd 8 included): the wgmma kernels, the loops that the
//   fused block and the ring already run. hstu_fwd_wgmma_kernel<W> is the
//   ring's pair_fwd_wgmma_kernel at offset 0 with Lq = Lk = L: one
//   warpgroup per (64-query tile, batch row) with all its heads, the
//   heaviest tiles first; qs = T(q_h hd^-1/2) of every head held in
//   swizzled shared memory (rounded as the tile lands, padded with zeros to
//   W = 16, 32, 64 or 128 columns); a two-stage cp.async ring over (head,
//   key tile up to the diagonal) streams k_h, v_h, the keys' valid flags
//   and the tile's 127 biases into the attention step of
//   csrc/fused_block_sm90.cuh (attn_step: S = qs k^T as an SS wgmma,
//   silu, bias, mask and 1/L in registers, acc += T(a) v_h as an RS
//   wgmma); each head's sum is stored in bf16 from the accumulator. The
//   backward is the fused block's pair of kernels in their standalone
//   instance (q rounded to T(q hd^-1/2) in shared memory, a and ds times
//   1/L before they round, bf16 outputs) with the rel-pos partials per
//   (batch row, query tile) summed by reduce_rows_split_kernel.
// - f32 (the tight check instance) and every other head (hd past 128, or
//   not a multiple of 8): the first design below.
//
// The first design: one block of 256 threads owns one (query tile, head,
// batch row) and streams key tiles of its head's slice through shared
// memory up to the diagonal (tiles above it skipped, heaviest query tiles
// first), so shared memory is flat in L. Tiles are TQ = 64 rows, or 32 or
// 16 where a wide head would not fit 227 KB of shared memory. Past the
// width where a 16-row q, k, v and output tile set fits (the backward's
// past hd 840 in bf16 and 560 in f32, the forward's past 1,400 and 870),
// the head streams through in column slices of HS: each
// output slice walks its key (query) tiles again, the scores s (and da)
// summed over every slice of q and k (do and v) before the SiLU, and the
// output, dq, dk and dv written slice by slice (pick_tiles); the rel-pos
// gradient is summed in the first slice's walk. That recomputes the score
// products once per slice: a simple design that takes any hd. Products are 16x16x16 WMMA tiles, bf16 with f32 accumulators,
// where hd % 16 == 0; FMA loops otherwise (any hd) and for T = f32 (the
// check instance); the bias, SiLU and mask are f32. The backward is the
// fused block's attention half on this layout: hstu_bwd_dq walks the key
// tiles of a query tile (dq), hstu_bwd_dkdv the query tiles at or below a
// key tile's diagonal (dk, dv, and the rel-pos gradient summed per tile
// diagonal into a per-(batch row, key tile) slice), and reduce_rows sums
// the slices in a fixed order.
//
// silu_qkv (the TPU kernels' static flag, in all five bodies): q, k and v
// are the pre-activations. Every kernel applies the SiLU in f32 as its q,
// k and v tiles land, q to T(silu(q) hd^-1/2) with one rounding, k and v
// to T(silu(.)) (_load_qkv, l.143), and the backward multiplies dq (after
// hd^-1/2), dk and dv by dsilu of the output rows' pre-activations, read
// from global memory (l.250-261, 375, 424); dk sums against the rounded
// T(silu(q) hd^-1/2). The wgmma design takes it as a template parameter:
// hstu_fwd_wgmma_kernel<W, true> applies it to the held q tiles in
// load_tile_sync and to each ring stage's k and v in place, on the chunks
// a thread copied (silu_stage), before the ring's fence and attn_step's
// barrier; the backward pair's <W, 1, 1> instance does the same
// (hstu_attn_bwd_sm90.cuh). The first design reads it at run time
// (load_act, pre_grad). The fused block's and the ring's instances of the
// shared code compile as before.
//
// Both designs: no atomics, so two calls give the same bits (drab
// included); padded queries are not masked, as in the TPU kernels, and a
// batch row with no valid key gives exact zeros. Offsets into [B, L, D]
// and the partials are 64-bit.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s). hstu_mini with --maxlen
// 255 (B=64, L=256, D=64, H=4): forward 0.54 GFLOP of causal products
// (q.k^T and a.v) against 8.4 MB of q, k, v and out: 2.5 us, bound by
// bytes; backward 1.35 GFLOP (s, da, dv, dq, dk) against 14.7 MB: 4.4 us,
// bytes. With --maxlen 4095 (B=32, L=4096, D=64, H=4): forward 68.7 GFLOP,
// 0.069 ms; backward 171.8 GFLOP, 0.174 ms; both bound by operations.
// The first design recomputes s and da in both backward kernels and
// stages every product through shared memory; the wgmma kernels recompute s
// and da too (7 products where the least work is 5), with their operands
// and accumulators in registers.

#include "fused_block_common.cuh"
#include "fused_block_sm90.cuh"
#include "hstu_attn_bwd_sm90.cuh"

using namespace fbk;

namespace {

struct HstuArgs {
  const void* q;       // [B, L, D] T
  const void* k;       // [B, L, D] T
  const void* v;       // [B, L, D] T
  const int* valid;    // [B, L] nonzero = valid key
  const float* rab;    // [H, NB]
  const void* dout;    // backward: [B, L, D] T
  void* out;           // forward: [B, L, D] T
  void* dq;            // backward: [B, L, D] T
  void* dk;            // backward: [B, L, D] T
  void* dv;            // backward: [B, L, D] T
  float* part_rab;     // backward scratch [B * L / TQ, H, NB]
  float* drab;         // backward: [H, NB]
  int B, L, D, H, NB;
  int HS;              // first design: the head's columns a slice holds
  int silu;            // silu_qkv: q, k, v are pre-activations
  float scale;         // hd^-1/2
  float inv_len;       // 1 / L
};

// load_head of the first design's q, k and v tiles: with ``act``
// (silu_qkv) each element becomes T(silu(f32(element))), times ``scale``
// before it rounds where ``scaled`` (q: one rounding), one element a
// thread.
template <typename T>
__device__ void load_act(const T* src, int src_ld, int rows, int width,
                         T* dst, int ld, float scale, bool scaled,
                         bool act) {
  if (!act) {
    load_head<T>(src, src_ld, rows, width, dst, ld, scale, scaled);
    return;
  }
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    const float x = silu(to_f(src[(size_t)r * src_ld + c]));
    dst[(size_t)r * ld + c] = from_f<T>(scaled ? x * scale : x);
  }
}

// The first design's epilogue factor of a gradient element: dsilu (f32) of
// its pre-activation where silu_qkv, else 1.
template <typename T>
__device__ __forceinline__ float pre_grad(const T* pre, bool act) {
  return act ? dsilu(to_f(*pre)) : 1.0f;
}

template <typename T>
size_t fwd_smem(int hs, int TQ) {
  return 3 * align128((size_t)TQ * (hs + 8) * sizeof(T))  // q, k, v
         + align128((size_t)TQ * kLdS * sizeof(float))     // s
         + align128((size_t)TQ * kLdP * sizeof(T))         // a
         + align128((size_t)TQ * (hs + 4) * sizeof(float)) // out sum
         + align128(TQ * sizeof(int));                     // key valid
}

// The first design's forward. With HS >= hd the whole head sits in shared
// memory (q loaded once); past that width the head streams through in
// column slices of HS: each output slice walks the key tiles again, the
// scores summed over every slice of q and k first.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
    hstu_fwd_kernel(HstuArgs p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, hd = D / p.H, L = p.L, NB = p.NB, HS = p.HS;
  const int ldh = HS + 8, lda = HS + 4;
  const bool whole = HS >= hd;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TQ;

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
  T* as = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)TQ * kLdP * sizeof(T));
  float* acc = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TQ * lda * sizeof(float));
  int* kval = reinterpret_cast<int*>(ptr);

  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const float* rab = p.rab + (size_t)h * NB;
  const T* Q = static_cast<const T*>(p.q) + (rowb + q0) * D + col;
  const T* K = static_cast<const T*>(p.k) + rowb * D + col;
  const T* V = static_cast<const T*>(p.v) + rowb * D + col;
  const bool act = p.silu != 0;
  if (whole) load_act<T>(Q, D, TQ, hd, qs, ldh, p.scale, true, act);

  for (int c0 = 0; c0 < hd; c0 += HS) {
    const int cw = min(HS, hd - c0);
    for (int i = threadIdx.x; i < TQ * cw; i += kThreads)
      acc[(i / cw) * lda + i % cw] = 0.0f;
    for (int kt = 0; kt <= qt; ++kt) {
      const size_t k0 = (size_t)kt * TQ;
      // s = sum over the head's slices of qs_s k_s^T
      for (int s0 = 0; s0 < hd; s0 += HS) {
        const int sw = min(HS, hd - s0);
        __syncthreads();  // the previous products are done with the tiles
        if (!whole)
          load_act<T>(Q + s0, D, TQ, sw, qs, ldh, p.scale, true, act);
        load_act<T>(K + k0 * D + s0, D, TQ, sw, ks, ldh, 1.0f, false, act);
        if (s0 == 0) {
          load_act<T>(V + k0 * D + c0, D, TQ, cw, vs, ldh, 1.0f, false, act);
          for (int j = threadIdx.x; j < TQ; j += kThreads)
            kval[j] = p.valid[rowb + k0 + j];
        }
        __syncthreads();
        if (s0 == 0)
          gemm<T, false, true, false>(qs, ldh, ks, ldh, ss, kLdS, TQ, TQ, sw,
                                      tc);
        else
          gemm<T, false, true, true>(qs, ldh, ks, ldh, ss, kLdS, TQ, TQ, sw,
                                     tc);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < TQ * TQ; i += kThreads) {
        const int r = i / TQ, c = i - r * TQ;
        const int dist = (q0 + r) - (int)(k0 + c);
        float a = 0.0f;
        if (dist >= 0 && kval[c] != 0)
          a = silu(ss[r * kLdS + c] + rab[min(dist, NB - 1)]) * p.inv_len;
        as[r * kLdP + c] = from_f<T>(a);
      }
      __syncthreads();
      gemm<T, false, false, true>(as, kLdP, vs, ldh, acc, lda, TQ, cw, TQ,
                                  tc);
    }
    __syncthreads();
    T* out = static_cast<T*>(p.out) + (rowb + q0) * D + col + c0;
    for (int i = threadIdx.x; i < TQ * cw; i += kThreads) {
      const int r = i / cw, d = i - r * cw;
      out[(size_t)r * D + d] = from_f<T>(acc[r * lda + d]);
    }
    __syncthreads();
  }
}

template <typename T>
size_t bwd_smem(int hs, int NB, int TQ) {
  return 4 * align128((size_t)TQ * (hs + 8) * sizeof(T))   // q, do, k, v
         + 2 * align128((size_t)TQ * kLdS * sizeof(float))  // s, da/ds
         + 2 * align128((size_t)TQ * kLdP * sizeof(T))      // a, T(ds)
         + 2 * align128((size_t)TQ * (hs + 4) * sizeof(float))  // sums
         + align128(TQ * sizeof(int))                       // key valid
         + align128(NB * sizeof(float))                     // drab slice
         + align128(2 * TQ * sizeof(float));                // diagonals
}

// The shared-memory carve-out of both backward kernels (hs: the columns of
// the head a slice holds).
template <typename T>
struct BwdTiles {
  T *qs, *dos, *ks, *vs, *as, *dss;
  float *ss, *das, *acc1, *acc2, *drab, *diag;
  int* kval;

  __device__ BwdTiles(unsigned char* ptr, int hs, int NB, int TQ) {
    const size_t tile = align128((size_t)TQ * (hs + 8) * sizeof(T));
    const size_t ftile = align128((size_t)TQ * kLdS * sizeof(float));
    const size_t ptile = align128((size_t)TQ * kLdP * sizeof(T));
    const size_t atile = align128((size_t)TQ * (hs + 4) * sizeof(float));
    qs = reinterpret_cast<T*>(ptr);
    dos = reinterpret_cast<T*>(ptr + tile);
    ks = reinterpret_cast<T*>(ptr + 2 * tile);
    vs = reinterpret_cast<T*>(ptr + 3 * tile);
    ptr += 4 * tile;
    ss = reinterpret_cast<float*>(ptr);
    das = reinterpret_cast<float*>(ptr + ftile);
    ptr += 2 * ftile;
    as = reinterpret_cast<T*>(ptr);
    dss = reinterpret_cast<T*>(ptr + ptile);
    ptr += 2 * ptile;
    acc1 = reinterpret_cast<float*>(ptr);
    acc2 = reinterpret_cast<float*>(ptr + atile);
    ptr += 2 * atile;
    kval = reinterpret_cast<int*>(ptr);
    ptr += align128(TQ * sizeof(int));
    drab = reinterpret_cast<float*>(ptr);
    ptr += align128(NB * sizeof(float));
    diag = reinterpret_cast<float*>(ptr);
  }
};

// s += qs k^T and da += do v^T over ``width`` columns of the head (the
// first slice writes, later ones add).
template <typename T, int TQ>
__device__ void pair_scores(BwdTiles<T>& t, int ldh, int width, bool tc,
                            bool accum) {
  if (accum) {
    gemm<T, false, true, true>(t.qs, ldh, t.ks, ldh, t.ss, kLdS, TQ, TQ,
                               width, tc);
    gemm<T, false, true, true>(t.dos, ldh, t.vs, ldh, t.das, kLdS, TQ, TQ,
                               width, tc);
  } else {
    gemm<T, false, true, false>(t.qs, ldh, t.ks, ldh, t.ss, kLdS, TQ, TQ,
                                width, tc);
    gemm<T, false, true, false>(t.dos, ldh, t.vs, ldh, t.das, kLdS, TQ, TQ,
                                width, tc);
  }
}

// On the visible pairs of one tile pair (s and da summed, a barrier
// before): the bias and SiLU, a (into as, when given) and ds = da *
// dsilu(s) / L (f32 into das, rounded into dss); zero elsewhere; a barrier
// after.
template <typename T, int TQ>
__device__ void pair_values(const HstuArgs& p, BwdTiles<T>& t,
                            const float* rab, int q0, int k0, bool with_a) {
  const int NB = p.NB;
  for (int i = threadIdx.x; i < TQ * TQ; i += kThreads) {
    const int r = i / TQ, c = i - r * TQ;
    const int dist = (q0 + r) - (k0 + c);
    float a = 0.0f, ds = 0.0f;
    if (dist >= 0 && t.kval[c] != 0) {
      const float s = t.ss[r * kLdS + c] + rab[min(dist, NB - 1)];
      a = silu(s) * p.inv_len;
      ds = t.das[r * kLdS + c] * dsilu(s) * p.inv_len;
    }
    if (with_a) t.as[r * kLdP + c] = from_f<T>(a);
    t.das[r * kLdS + c] = ds;
    t.dss[r * kLdP + c] = from_f<T>(ds);
  }
  __syncthreads();
}

// dq of one query tile, walking the key tiles up to its diagonal; past HS
// columns, once per output slice, the scores summed over every slice.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
    hstu_bwd_dq_kernel(HstuArgs p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, hd = D / p.H, L = p.L, HS = p.HS;
  const int ldh = HS + 8, lda = HS + 4;
  const bool whole = HS >= hd;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * TQ;
  BwdTiles<T> t(smem, HS, p.NB, TQ);

  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const float* rab = p.rab + (size_t)h * p.NB;
  const T* Q = static_cast<const T*>(p.q) + (rowb + q0) * D + col;
  const T* DO = static_cast<const T*>(p.dout) + (rowb + q0) * D + col;
  const T* K = static_cast<const T*>(p.k) + rowb * D + col;
  const T* V = static_cast<const T*>(p.v) + rowb * D + col;
  const bool act = p.silu != 0;
  if (whole) {
    load_act<T>(Q, D, TQ, hd, t.qs, ldh, p.scale, true, act);
    load_head<T>(DO, D, TQ, hd, t.dos, ldh, 1.0f, false);
  }

  for (int c0 = 0; c0 < hd; c0 += HS) {
    const int cw = min(HS, hd - c0);
    for (int i = threadIdx.x; i < TQ * cw; i += kThreads)
      t.acc1[(i / cw) * lda + i % cw] = 0.0f;
    for (int kt = 0; kt <= qt; ++kt) {
      const size_t k0 = (size_t)kt * TQ;
      for (int s0 = 0; s0 < hd; s0 += HS) {
        const int sw = min(HS, hd - s0);
        __syncthreads();  // the previous products are done with the tiles
        if (!whole) {
          load_act<T>(Q + s0, D, TQ, sw, t.qs, ldh, p.scale, true, act);
          load_head<T>(DO + s0, D, TQ, sw, t.dos, ldh, 1.0f, false);
        }
        load_act<T>(K + k0 * D + s0, D, TQ, sw, t.ks, ldh, 1.0f, false,
                    act);
        load_act<T>(V + k0 * D + s0, D, TQ, sw, t.vs, ldh, 1.0f, false,
                    act);
        if (s0 == 0)
          for (int j = threadIdx.x; j < TQ; j += kThreads)
            t.kval[j] = p.valid[rowb + k0 + j];
        __syncthreads();
        pair_scores<T, TQ>(t, ldh, sw, tc, s0 > 0);
      }
      __syncthreads();
      // the output slice's columns of k (the whole head is there already)
      if (!whole)
        load_act<T>(K + k0 * D + c0, D, TQ, cw, t.ks, ldh, 1.0f, false, act);
      pair_values<T, TQ>(p, t, rab, q0, (int)k0, false);
      // dq += T(ds) k
      gemm<T, false, false, true>(t.dss, kLdP, t.ks, ldh, t.acc1, lda, TQ,
                                  cw, TQ, tc);
    }
    __syncthreads();
    T* dq = static_cast<T*>(p.dq) + (rowb + q0) * D + col + c0;
    for (int i = threadIdx.x; i < TQ * cw; i += kThreads) {
      const int r = i / cw, d = i - r * cw;
      // silu_qkv: times dsilu of the pre-activation q (after the scale)
      dq[(size_t)r * D + d] = from_f<T>(
          t.acc1[r * lda + d] * p.scale *
          pre_grad(Q + (size_t)r * D + c0 + d, act));
    }
    __syncthreads();
  }
}

// dk, dv of one key tile, walking the query tiles at or below its
// diagonal, and the rel-pos gradient of the same pairs per tile diagonal
// (in the first output slice's walk); past HS columns, once per output
// slice, the scores summed over every slice.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
    hstu_bwd_dkdv_kernel(HstuArgs p, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, H = p.H, hd = D / H, L = p.L, NB = p.NB, HS = p.HS;
  const int ldh = HS + 8, lda = HS + 4;
  const bool whole = HS >= hd;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * TQ;
  BwdTiles<T> t(smem, HS, NB, TQ);
  float* dk = t.acc1;
  float* dv = t.acc2;

  const size_t rowb = (size_t)b * L, col = (size_t)h * hd;
  const float* rab = p.rab + (size_t)h * NB;
  const T* K = static_cast<const T*>(p.k) + (rowb + k0) * D + col;
  const T* V = static_cast<const T*>(p.v) + (rowb + k0) * D + col;
  const T* Q = static_cast<const T*>(p.q) + rowb * D + col;
  const T* DO = static_cast<const T*>(p.dout) + rowb * D + col;
  const bool act = p.silu != 0;
  if (whole) {
    load_act<T>(K, D, TQ, hd, t.ks, ldh, 1.0f, false, act);
    load_act<T>(V, D, TQ, hd, t.vs, ldh, 1.0f, false, act);
  }
  for (int j = threadIdx.x; j < TQ; j += kThreads)
    t.kval[j] = p.valid[rowb + k0 + j];
  for (int i = threadIdx.x; i < NB; i += kThreads) t.drab[i] = 0.0f;

  for (int c0 = 0; c0 < hd; c0 += HS) {
    const int cw = min(HS, hd - c0);
    for (int i = threadIdx.x; i < TQ * cw; i += kThreads) {
      dk[(i / cw) * lda + i % cw] = 0.0f;
      dv[(i / cw) * lda + i % cw] = 0.0f;
    }
    for (int qt = kt; qt < L / TQ; ++qt) {
      const size_t q0 = (size_t)qt * TQ;
      for (int s0 = 0; s0 < hd; s0 += HS) {
        const int sw = min(HS, hd - s0);
        __syncthreads();  // the previous products are done with the tiles
        load_act<T>(Q + q0 * D + s0, D, TQ, sw, t.qs, ldh, p.scale, true,
                    act);
        load_head<T>(DO + q0 * D + s0, D, TQ, sw, t.dos, ldh, 1.0f, false);
        if (!whole) {
          load_act<T>(K + s0, D, TQ, sw, t.ks, ldh, 1.0f, false, act);
          load_act<T>(V + s0, D, TQ, sw, t.vs, ldh, 1.0f, false, act);
        }
        __syncthreads();
        pair_scores<T, TQ>(t, ldh, sw, tc, s0 > 0);
      }
      __syncthreads();
      // the output slice's columns of qs and do
      if (!whole) {
        load_act<T>(Q + q0 * D + c0, D, TQ, cw, t.qs, ldh, p.scale, true,
                    act);
        load_head<T>(DO + q0 * D + c0, D, TQ, cw, t.dos, ldh, 1.0f, false);
      }
      pair_values<T, TQ>(p, t, rab, (int)q0, k0, true);
      // dv += a^T do;  dk += T(ds)^T qs
      gemm<T, true, false, true>(t.as, kLdP, t.dos, ldh, dv, lda, TQ, cw, TQ,
                                 tc);
      gemm<T, true, false, true>(t.dss, kLdP, t.qs, ldh, dk, lda, TQ, cw, TQ,
                                 tc);
      if (c0 == 0) {
        // rel-pos gradient: diagonal e of the tile holds the pairs at
        // distance q0 - k0 + e - (TQ - 1); distances below NB - 1 are
        // distinct per diagonal, the clamped ones fold in order below
        for (int e = threadIdx.x; e < 2 * TQ - 1; e += kThreads) {
          const int off = e - (TQ - 1);  // r - c
          float s = 0.0f;
          for (int r = max(0, off); r < min(TQ, TQ + off); ++r)
            s += t.das[r * kLdS + (r - off)];
          t.diag[e] = s;
          const int dist = (int)q0 - k0 + off;
          if (dist >= 0 && dist < NB - 1) t.drab[dist] += s;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int e = 0; e < 2 * TQ - 1; ++e)
            if ((int)q0 - k0 + e - (TQ - 1) >= NB - 1)
              t.drab[NB - 1] += t.diag[e];
        }
      }
    }
    __syncthreads();
    T* dko = static_cast<T*>(p.dk) + (rowb + k0) * D + col + c0;
    T* dvo = static_cast<T*>(p.dv) + (rowb + k0) * D + col + c0;
    for (int i = threadIdx.x; i < TQ * cw; i += kThreads) {
      const int r = i / cw, d = i - r * cw;
      // silu_qkv: times dsilu of the pre-activation k and v
      const size_t at = (size_t)r * D + c0 + d;
      dko[(size_t)r * D + d] = from_f<T>(dk[r * lda + d] *
                                         pre_grad(K + at, act));
      dvo[(size_t)r * D + d] = from_f<T>(dv[r * lda + d] *
                                         pre_grad(V + at, act));
    }
    __syncthreads();
  }
  float* out = p.part_rab + (((size_t)b * gridDim.x + kt) * H + h) * NB;
  for (int i = threadIdx.x; i < NB; i += kThreads) out[i] = t.drab[i];
}

// out[i] = sum over g of part[g * P + i]. A block sums 32 columns: warp w
// takes rows w, w + 8, ... in order, then warp 0 adds the 8 partial sums
// in warp order. A fixed order, so deterministic; the rows are split 8
// ways because G = B * L / TQ reaches 8,192 at B=32, L=16384.
__global__ void __launch_bounds__(kThreads)
    reduce_rows_kernel(const float* part, int G, int P, float* out) {
  __shared__ float sums[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (i < P) {
#pragma unroll 4
    for (int g = warp; g < G; g += kWarps) s += part[(size_t)g * P + i];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < P) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sums[w][lane];
    out[i] = t;
  }
}

bool shapes_ok(int B, int L, int D, int H, int NB) {
  return B > 0 && H > 0 && L > 0 && NB > 0 && L % 64 == 0 && D % H == 0;
}

// The first design's tiles: TQ query (key) rows and HS columns of the head
// a slice holds. The whole head in 64, 32 or 16 rows where it fits shared
// memory; past that width 16 rows and column slices of 512, 256, ... 16
// (the widest that fits).
struct Tiles {
  int tq, hs;
};

template <typename T>
Tiles pick_tiles(int hd, int NB, bool bwd) {
  auto fits = [&](int hs, int tq) {
    return (bwd ? bwd_smem<T>(hs, NB, tq) : fwd_smem<T>(hs, tq)) <= kMaxSmem;
  };
  for (int t = 64; t >= 16; t >>= 1)
    if (fits(hd, t)) return {t, hd};
  for (int hs = 512; hs >= 16; hs >>= 1)
    if (hs < hd && fits(hs, 16)) return {16, hs};
  return {0, 0};
}

template <typename T>
bool use_tc(int hd) {
  return std::is_same<T, bf16>::value && hd % 16 == 0;
}

template <typename T, int TQ>
int launch_fwd_tiles(HstuArgs p, int hs, cudaStream_t stream) {
  p.HS = hs;
  const size_t sm = fwd_smem<T>(hs, TQ);
  cudaError_t e = cudaFuncSetAttribute(
      hstu_fwd_kernel<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.L / TQ, p.H, p.B);
  hstu_fwd_kernel<T, TQ><<<grid, kThreads, sm, stream>>>(
      p, use_tc<T>(p.D / p.H));
  return (int)cudaGetLastError();
}

template <typename T, int TQ>
int launch_bwd_tiles(HstuArgs p, int hs, cudaStream_t stream) {
  p.HS = hs;
  const size_t sm = bwd_smem<T>(hs, p.NB, TQ);
  cudaError_t e = cudaFuncSetAttribute(
      hstu_bwd_dq_kernel<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(hstu_bwd_dkdv_kernel<T, TQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm);
  if (e != cudaSuccess) return (int)e;
  const bool tc = use_tc<T>(p.D / p.H);
  const dim3 grid(p.L / TQ, p.H, p.B);
  hstu_bwd_dq_kernel<T, TQ><<<grid, kThreads, sm, stream>>>(p, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hstu_bwd_dkdv_kernel<T, TQ><<<grid, kThreads, sm, stream>>>(p, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int hnb = p.H * p.NB;
  reduce_rows_kernel<<<(hnb + 31) / 32, kThreads, 0, stream>>>(
      p.part_rab, p.B * (p.L / TQ), hnb, p.drab);
  return (int)cudaGetLastError();
}

// The tile rows are a template argument, so that the tile loops unroll as
// the 64-row design's did.
template <typename T>
int launch_fwd(const HstuArgs& p, cudaStream_t stream) {
  const Tiles t = pick_tiles<T>(p.D / p.H, p.NB, false);
  switch (t.tq) {
    case 64: return launch_fwd_tiles<T, 64>(p, t.hs, stream);
    case 32: return launch_fwd_tiles<T, 32>(p, t.hs, stream);
    case 16: return launch_fwd_tiles<T, 16>(p, t.hs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_bwd(const HstuArgs& p, cudaStream_t stream) {
  const Tiles t = pick_tiles<T>(p.D / p.H, p.NB, true);
  switch (t.tq) {
    case 64: return launch_bwd_tiles<T, 64>(p, t.hs, stream);
    case 32: return launch_bwd_tiles<T, 32>(p, t.hs, stream);
    case 16: return launch_bwd_tiles<T, 16>(p, t.hs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the wgmma design (bf16, hd % 8 == 0, hd <= 128)
// ---------------------------------------------------------------------------

// The forward's shared memory: the qs tiles of every head held, k and v of
// each (head, key tile) step and its row data through the ring.
template <int W>
__host__ __device__ inline sm90::Carve<W> fwd_carve(int H) {
  return sm90::Carve<W>{H, 2, 0};
}

// silu_qkv on a ring stage's k or v tile: T(silu(.)) in place on the
// chunks this thread copied in fb90::attn_issue (load_mat's order: chunk i
// = threadIdx.x + j kWg of the tile's kRows x W / 8), the hd real columns;
// after the ring's wait, before its fence (the barrier in attn_step then
// shows every thread's chunks to the products).
template <int W>
__device__ __forceinline__ void silu_stage(bf16* t, int hd) {
  constexpr int kCh = W / 8;
  unsigned char* tb = reinterpret_cast<unsigned char*>(t);
  for (int i = threadIdx.x; i < fb90::kRows * kCh; i += fb90::kWg) {
    const int r = i / kCh, c = (i % kCh) * 8;
    if (c >= hd) continue;
    uint4* q = reinterpret_cast<uint4*>(
        tb + sm90::Tile<W>::offset(r, c, fb90::kRows));
    uint4 raw = *q;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(sm90::silu_f32(__bfloat162float(e[j])));
    *q = raw;
  }
}

template <int W, bool kSilu>
__global__ void __launch_bounds__(fb90::kWg, W <= 64 ? 4 : 2)
    hstu_fwd_wgmma_kernel(HstuArgs p) {
  constexpr int kR = fb90::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const sm90::Carve<W> cv = fwd_carve<W>(p.H);
  const int D = p.D, H = p.H, hd = D / H, NB = p.NB;
  const int b = blockIdx.y, qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kR;
  const int n = qt + 1;   // key tiles 0 .. qt hold a pair at distance >= 0
  const int steps = H * n;
  const size_t rowq = (size_t)b * p.L + q0, rowk = (size_t)b * p.L;
  const bf16* K = static_cast<const bf16*>(p.k) + rowk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + rowk * D;
  bf16* out = static_cast<bf16*>(p.out) + rowq * D;

  // qs = T(q_h hd^-1/2) of every head (kSilu: T(silu(q_h) hd^-1/2)); the
  // loads never write the padding columns hd..W-1, so those are zeroed
  // first. The ring's first fence and the barrier in attn_step make these
  // stores visible to the products.
  if (hd < W) sm90::zero_smem(base, (size_t)H * cv.kTileBytes, fb90::kWg);
  __syncthreads();
  for (int h = 0; h < H; ++h)
    sm90::load_tile_sync<W, kSilu>(
        cv.held(base, h), static_cast<const bf16*>(p.q) + rowq * D + h * hd,
        D, kR, hd, fb90::kWg, true, p.scale, true);
  auto issue = [&](int s) {
    if (s < steps) {
      const int h = s / n, k0 = (s - h * n) * kR, st = s % sm90::kStages;
      fb90::attn_issue<W, false>(
          cv.tile(base, st, 0), cv.tile(base, st, 1), cv.rows(base, st),
          K + (size_t)k0 * D + h * hd, V + (size_t)k0 * D + h * hd,
          p.valid + rowk + k0, p.rab + (size_t)h * NB, D, hd, kR, q0 - k0,
          NB);
    }
    sm90::cp_async_commit();
  };

  // head h's sum to its columns in bf16, the accumulator cleared
  float acc[W / 2], s[32];
  const int r0 = sm90::acc_row(0), c0 = sm90::acc_col(0);
  auto store = [&](int h) {
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int r = sm90::acc_row(i), c = sm90::acc_col(i);
      if (c < hd)
        hstu_bwd::store_pair(out + (size_t)r * D + h * hd + c, acc[i],
                             acc[i + 1]);
      acc[i] = acc[i + 1] = 0.0f;
    }
  };
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  issue(0);
  for (int step = 0; step < steps; ++step) {
    issue(step + 1);
    sm90::cp_async_wait<1>();
    const int h = step / n, kt = step - h * n, st = step % sm90::kStages;
    if constexpr (kSilu) {   // T(silu(k_h)), T(silu(v_h)) as they land
      silu_stage<W>(cv.tile(base, st, 0), hd);
      silu_stage<W>(cv.tile(base, st, 1), hd);
    }
    sm90::fence_async_smem();
    fb90::attn_step<W>(acc, s, cv.held(base, h), cv.tile(base, st, 0),
                       cv.tile(base, st, 1), cv.rows(base, st), q0 - kt * kR,
                       r0, c0, p.inv_len);
    if (kt == n - 1) store(h);
    __syncthreads();  // this stage is read; a later issue reloads it
  }
}

// Whether the wgmma kernels take H heads of D / H columns: the attention
// loop takes them (fb90::attn_heads: hd % 8 == 0, hd <= 128; every HSTU
// preset) and the forward's held q tiles fit shared memory (H x W up to
// about 1,700 columns).
bool wgmma_heads(int D, int H) {
  if (H <= 0 || D % H != 0 || !fb90::attn_heads(D, H)) return false;
  switch (sm90::wgmma_width(D / H)) {
    case 16: return fwd_carve<16>(H).bytes() <= kMaxSmem;
    case 32: return fwd_carve<32>(H).bytes() <= kMaxSmem;
    case 64: return fwd_carve<64>(H).bytes() <= kMaxSmem;
    default: return fwd_carve<128>(H).bytes() <= kMaxSmem;
  }
}

// Which design runs: the wgmma kernels in bf16 where they take the heads;
// the first design in f32 (the tight check instance) and for other heads
// (any hd past 128). The one place that chooses: a launch the chosen design
// cannot make fails, and the wrapper raises.
bool hstu_wgmma_route(bool is_bf16, int D, int H) {
  return is_bf16 && wgmma_heads(D, H);
}

template <int W>
int launch_fwd_wgmma(const HstuArgs& p, cudaStream_t stream) {
  const dim3 grid(p.L / fb90::kRows, p.B);
  const size_t sm = fwd_carve<W>(p.H).bytes();
  if (p.silu)
    return hstu_bwd::launch_kernel(hstu_fwd_wgmma_kernel<W, true>, grid,
                                   fb90::kWg, sm, stream, p);
  return hstu_bwd::launch_kernel(hstu_fwd_wgmma_kernel<W, false>, grid,
                                 fb90::kWg, sm, stream, p);
}

int launch_fwd_wgmma_any(const HstuArgs& p, cudaStream_t stream) {
  // the operands it copies and stores in 16-byte chunks: a misaligned one
  // fails the launch (the wrapper checks their alignment first)
  if (!sm90::aligned16(p.q) || !sm90::aligned16(p.k) ||
      !sm90::aligned16(p.v) || !sm90::aligned16(p.out))
    return (int)cudaErrorInvalidValue;
  switch (sm90::wgmma_width(p.D / p.H)) {
    case 16: return launch_fwd_wgmma<16>(p, stream);
    case 32: return launch_fwd_wgmma<32>(p, stream);
    case 64: return launch_fwd_wgmma<64>(p, stream);
    default: return launch_fwd_wgmma<128>(p, stream);
  }
}

// The backward's arguments at offset 0 with the standalone rounding points:
// q rounds to T(q hd^-1/2), a and ds take 1/L before they round, dq is
// times hd^-1/2 and every gradient but drab is stored in T.
hstu_bwd::AttnBwdArgs attn_args(const HstuArgs& p) {
  hstu_bwd::AttnBwdArgs a = {};
  a.q = p.q;
  a.k = p.k;
  a.v = p.v;
  a.dav = p.dout;
  a.valid = p.valid;
  a.rab = p.rab;
  a.dq = p.dq;
  a.dk = p.dk;
  a.dv = p.dv;
  a.part_rab = p.part_rab;
  a.drab = p.drab;
  a.B = p.B;
  a.Lq = a.Lk = p.L;
  a.D = p.D;
  a.H = p.H;
  a.NB = p.NB;
  a.off = 0;
  a.dq_scale = p.scale;
  a.q_scale = p.scale;
  a.a_mul = p.inv_len;
  return a;
}

int launch_bwd_wgmma(const HstuArgs& p, cudaStream_t stream) {
  if (!sm90::aligned16(p.q) || !sm90::aligned16(p.k) ||
      !sm90::aligned16(p.v) || !sm90::aligned16(p.dout) ||
      !sm90::aligned16(p.dq) || !sm90::aligned16(p.dk) ||
      !sm90::aligned16(p.dv))
    return (int)cudaErrorInvalidValue;
  const hstu_bwd::AttnBwdArgs a = attn_args(p);
  if (p.silu) {   // the silu_qkv instances
    switch (sm90::wgmma_width(p.D / p.H)) {
      case 16: return hstu_bwd::launch_wgmma<16, true, true>(a, true, true,
                                                             stream);
      case 32: return hstu_bwd::launch_wgmma<32, true, true>(a, true, true,
                                                             stream);
      case 64: return hstu_bwd::launch_wgmma<64, true, true>(a, true, true,
                                                             stream);
      default: return hstu_bwd::launch_wgmma<128, true, true>(a, true, true,
                                                              stream);
    }
  }
  switch (sm90::wgmma_width(p.D / p.H)) {
    case 16: return hstu_bwd::launch_wgmma<16, true>(a, true, true, stream);
    case 32: return hstu_bwd::launch_wgmma<32, true>(a, true, true, stream);
    case 64: return hstu_bwd::launch_wgmma<64, true>(a, true, true, stream);
    default: return hstu_bwd::launch_wgmma<128, true>(a, true, true, stream);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v, out, dout, dq, dk, dv
// [B, L, D] head-packed in the compute dtype (bf16 when is_bf16, else
// f32; q, k, v the pre-activations and dq, dk, dv their gradients when
// silu, the silu_qkv instances), valid [B, L] int32, rab and drab [H, NB] f32, part_rab
// [B * L / hstu_attn_bwd_tile(...), H, NB] f32 scratch; all contiguous and
// 16-byte aligned. Requires L % 64 == 0 and D % H == 0 (any hd = D / H).
// Each launch returns a cudaError_t code (0 on success).

// The backward's query rows per rel-pos partial at this dtype, shape and
// bucket count: 64 on the wgmma route; the first design's tile (64, 32 or
// 16) otherwise; 0 where no tile fits.
extern "C" int hstu_attn_bwd_tile(int is_bf16, int D, int H, int NB) {
  if (H <= 0 || D % H != 0) return 0;
  if (hstu_wgmma_route(is_bf16 != 0, D, H)) return hstu_bwd::kTile;
  return is_bf16 ? pick_tiles<bf16>(D / H, NB, true).tq
                 : pick_tiles<float>(D / H, NB, true).tq;
}

extern "C" int hstu_attn_fwd(int is_bf16, int silu, const void* q,
                             const void* k, const void* v, const void* valid,
                             const void* rab, void* out, int B, int L, int D,
                             int H, int NB, float scale, float inv_len,
                             void* stream) {
  if (!shapes_ok(B, L, D, H, NB)) return (int)cudaErrorInvalidValue;
  HstuArgs p = {};
  p.silu = silu;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int*>(valid);
  p.rab = static_cast<const float*>(rab);
  p.out = out;
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.NB = NB;
  p.scale = scale;
  p.inv_len = inv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hstu_wgmma_route(is_bf16 != 0, D, H)) return launch_fwd_wgmma_any(p, s);
  return is_bf16 ? launch_fwd<bf16>(p, s) : launch_fwd<float>(p, s);
}

extern "C" int hstu_attn_bwd(int is_bf16, int silu, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* valid, const void* rab, void* dq,
                             void* dk, void* dv, void* part_rab, void* drab,
                             int B, int L, int D, int H, int NB, float scale,
                             float inv_len, void* stream) {
  if (!shapes_ok(B, L, D, H, NB)) return (int)cudaErrorInvalidValue;
  HstuArgs p = {};
  p.silu = silu;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const int*>(valid);
  p.rab = static_cast<const float*>(rab);
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.part_rab = static_cast<float*>(part_rab);
  p.drab = static_cast<float*>(drab);
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.NB = NB;
  p.scale = scale;
  p.inv_len = inv_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hstu_wgmma_route(is_bf16 != 0, D, H)) return launch_bwd_wgmma(p, s);
  return is_bf16 ? launch_bwd<bf16>(p, s) : launch_bwd<float>(p, s);
}
