// Fused pre-norm HSTU block forward for Hopper, sm_90a, in inference and in
// training.
//
// Replaces tencent_recommendation_2025_tpu/ops/fused_block.py::_fwd_kernel
// (the whole-sequence Pallas kernel, both modes) and the chunked variant's
// three stages: _fwd_pre_kernel_chunk (l.452) is proj_kernel below (its
// first stage, l.288-295, likewise), _fwd_attn_kernel_chunk (l.468) and
// _fwd_post_kernel_chunk (l.502) are the two halves of attn_ffn_kernel. Per batch row and token, with x [B, L, D]
// in the compute dtype T (bf16 on the product path, f32 in the checks):
//
//   h1   = LN1(x)                                   f32, eps 1e-8
//   uvqk = silu(T(h1) @ Wuvqk + b)                  f32 accumulation
//   u = uvqk[:D] (f32), v = T(uvqk[D:2D] / L), q = T(uvqk[2D:3D] * hd^-1/2),
//   k = T(uvqk[3D:])
//   av_h = sum_{k<=q, valid k} T(silu(q_h.k_h + rab[h, min(q-k, NB-1)])) v_h
//   g    = LN2(av) * u * keep1
//   y    = x + T(g) @ Wo + bo
//   out  = T(y + T(silu(x1) * x3 * keep2) @ W2),  [x1 | x3] = T(LN3(y)) @ W13
//
// Training (the wrapper passes an av output): av is also written in T, the
// residual the backward (fused_block_bwd.cu) reads, while LN2 here reads the
// f32 sum, as the whole-sequence TPU kernel does. The chunked variant
// (round_av, L > wholeseq_max_l(D)) rounds av to T before LN2, as the TPU's
// attention stage writes it in T for its post stage; the av written out is
// then the value LN2 read. With dropout (a seed pointer), keep1 and
// keep2 are the counter-hash masks of fused_block_common.cuh (site 0 over
// [L, D], site 1 over [L, F]); otherwise both are 1.
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
// TFLOP/s bf16 versus 10 us at 3.35 TB/s, so the bound is compute.
//
// Instances. In bf16 at D <= 128 (every fused preset) the two kernels are
// proj_wgmma_kernel and attn_ffn_wgmma_kernel (below, on csrc/
// fused_block_sm90.cuh): wgmma with register accumulators, the weights
// resident or streamed through a cp.async ring. In f32 (the instance that
// lets the card be checked tightly) and at D > 128, proj_kernel and
// attn_ffn_kernel run their products through WMMA (16x16x16 bf16, f32
// accumulate) in bf16 and as FMA loops in f32.

#include "fused_block_common.cuh"
#include "fused_block_sm90.cuh"

using namespace fbk;

namespace {

constexpr int kTM = 64;      // tokens per projection block

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
  void* av;            // training: [B, L, D] T, the attention output; or null
  const void* av_in;   // post stage alone: [B, L, D] T attention output read
                       // in place of the attention loop; or null
  const int* seed;     // training with dropout: [1] seed; null = no dropout
  int B, L, D, H, F, NB;
  int round_av;        // chunked variant: LN2 reads T(av), not the f32 sum
  float scale, inv_len;
  unsigned thr;        // dropout: keep iff bits >= thr
  float keep_scale;    // dropout: 1 / (1 - p)
};

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
    gemm<T, false, false, false>(hs, ldt, w + n0, 4 * D, cs, kLdS, kTM, kNC,
                                 D, tc);
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
  if (p.av_in) {
    // the post stage alone (a ring's): av comes in, in T
    const T* a = static_cast<const T*>(p.av_in) + (rowb + q0) * D;
    for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      av[r * ldf + d] = to_f(a[i]);
    }
    __syncthreads();
  } else {
    load_tile<T>(static_cast<const T*>(p.q) + (rowb + q0) * D, TQ, D, qs,
                 ldt);
    for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      av[r * ldf + d] = 0.0f;
    }
  }

  // --- attention: key tiles up to the diagonal ---
  for (int kt = 0; !p.av_in && kt <= qt; ++kt) {
    const int k0 = kt * TQ;
    __syncthreads();  // previous tile's products are done with ks/vs/ps
    load_tile<T>(static_cast<const T*>(p.k) + (rowb + k0) * D, TQ, D, ks, ldt);
    load_tile<T>(static_cast<const T*>(p.v) + (rowb + k0) * D, TQ, D, vs, ldt);
    for (int j = threadIdx.x; j < TQ; j += kThreads)
      kval[j] = p.valid[rowb + k0 + j];
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      gemm<T, false, true, false>(qs + h * hd, ldt, ks + h * hd, ldt, ss,
                                  kLdS, TQ, TQ, hd, tc_attn);
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
      gemm<T, false, false, true>(ps, kLdP, vs + h * hd, ldt, av + h * hd,
                                  ldf, TQ, hd, TQ, tc_attn);
      __syncthreads();
    }
  }

  // --- gate: g = LN2(av) * u * keep1; training also writes av ---
  if (p.round_av) {
    for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      av[r * ldf + d] = to_f(from_f<T>(av[r * ldf + d]));
    }
    __syncthreads();
  }
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;
  row_stats<float>(av, ldf, TQ, D, mu, rstd);
  __syncthreads();
  {
    const float* g2 = p.ln + 2 * D;
    const float* b2 = p.ln + 3 * D;
    const float* u = p.u + (rowb + q0) * D;
    T* av_out = p.av ? static_cast<T*>(p.av) + (rowb + q0) * D : nullptr;
    const uint32_t key = drop_key(seed, 2u * b);
    for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float g = ((av[r * ldf + d] - mu[r]) * rstd[r] * g2[d] + b2[d]) * u[i];
      if (drop)
        g *= keep_factor(key, (uint32_t)((q0 + r) * D + d), p.thr,
                         p.keep_scale);
      qs[r * ldt + d] = from_f<T>(g);
      if (av_out) av_out[i] = from_f<T>(av[r * ldf + d]);
    }
  }
  __syncthreads();

  // --- y = x + g @ Wo + bo, into the av buffer ---
  const T* x = static_cast<const T*>(p.x) + (rowb + q0) * D;
  const T* wo = static_cast<const T*>(p.wo);
  for (int n0 = 0; n0 < D; n0 += kNC) {
    const int nc = min(kNC, D - n0);
    gemm<T, false, false, false>(qs, ldt, wo + n0, D, ss, kLdS, TQ, nc, D,
                                 tc);
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

  // --- SwiGLU FFN in F-chunks: os += T(silu(x1) * x3 * keep2) @ W2[chunk]
  const T* w13 = static_cast<const T*>(p.w13);
  const T* w2 = static_cast<const T*>(p.w2);
  const uint32_t key2 = drop_key(seed, 2u * b + 1u);
  for (int j0 = 0; j0 < F; j0 += kNC) {
    const int nc = min(kNC, F - j0);
    gemm<T, false, false, false>(qs, ldt, w13 + j0, 2 * F, ss, kLdS, TQ, nc,
                                 D, tc);
    gemm<T, false, false, false>(qs, ldt, w13 + F + j0, 2 * F, s2, kLdS, TQ,
                                 nc, D, tc);
    __syncthreads();
    for (int i = threadIdx.x; i < TQ * nc; i += kThreads) {
      const int r = i / nc, c = i - r * nc;
      float f = silu(ss[r * kLdS + c]) * s2[r * kLdS + c];
      if (drop)
        f *= keep_factor(key2, (uint32_t)((q0 + r) * F + j0 + c), p.thr,
                         p.keep_scale);
      ps[r * kLdP + c] = from_f<T>(f);
    }
    __syncthreads();
    gemm<T, false, false, true>(ps, kLdP, w2 + (size_t)j0 * D, D, os, ldf, TQ,
                                D, nc, tc);
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out) + (rowb + q0) * D;
  for (int i = threadIdx.x; i < TQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[i] = from_f<T>(av[r * ldf + d] + os[r * ldf + d]);
  }
}

// ===========================================================================
// attn_ffn_wgmma_kernel: the bf16 instance on wgmma (csrc/fused_block_sm90.cuh)
// ===========================================================================
//
// The same function as attn_ffn_kernel, for bf16 at D <= 128 (padded to DW
// = 32, 64 or 128 columns) with head slices in whole 16-byte chunks (hd % 8
// == 0, padded to W = 16-128 columns as sm90::wgmma_width pads them). One
// warpgroup owns one 64-query tile of one batch row with all its heads
// (LN2 needs the whole row), the heaviest tiles first. A two-stage cp.async
// ring streams, step by step: for each head and each key tile up to the
// diagonal, k_h, v_h, the keys' valid flags and the tile's 127 rel-pos
// biases; then, for each F-chunk of 64 columns, the two W13 slices and the
// W2 rows of the chunk. Wo and the query tiles are loaded once.
//
// - Attention, per step (attn_issue and attn_step of csrc/fused_block_sm90
//   .cuh, the loop the ring's pair_fwd_wgmma_kernel runs too): S = q_h
//   k_h^T (SS wgmma), a = silu(s + bias) with the causal and key-valid mask
//   in registers (an unmasked path for tiles below the diagonal whose keys
//   are all valid), T(a) straight into the A operand of av_h += T(a) v_h
//   (RS wgmma). A head's sum goes to a shared f32 tile at its columns; with
//   one head whose width is DW it stays in registers.
// - The post half from av in registers: LN2 * u * keep1 by quad shuffles,
//   y = T(g) Wo + x + bo (RS, Wo an MN-major B), LN3, then per chunk x1 and
//   x3 = T(LN3(y)) [W13 slices] (RS), f = silu(x1) x3 keep2 rounded into A
//   fragments, out += T(f) W2[chunk] (RS) onto the y accumulator.
template <int W, int DW>
struct FwdCarve {
  static constexpr int kFC = fb90::FwdChunk<DW>::kFC;
  static constexpr size_t kWo = (size_t)DW * DW * 2;
  // tile sizes as constants (Tile<>::bytes is a host constexpr function)
  static constexpr size_t kQ = sm90::Tile<W>::bytes(fb90::kRows);
  static constexpr size_t kW13 = sm90::Tile<kFC>::bytes(DW);
  static constexpr size_t kTiles = fb90::cmax(
      2 * sm90::Tile<W>::bytes(fb90::kRows),
      fb90::cmax(2 * sm90::Tile<kFC>::bytes(DW),
                 sm90::Tile<DW>::bytes(kFC)));
  static constexpr size_t kStage = kTiles + 1024;  // + valid flags, biases
  static constexpr int kAvLd = DW + 8;             // av tile row stride
  int H;
  bool attn, av_tile;

  // With one head as wide as the padded row (at DW <= 64: at 128 the
  // attention's registers beside av would spill) av stays in the
  // attention's accumulator; else each head's sum goes to a shared tile.
  __host__ __device__ static FwdCarve of(int H, bool attn) {
    return {H, attn, attn && !(W == DW && DW <= 64 && H == 1)};
  }

  __host__ __device__ size_t q_bytes() const {
    return attn ? (size_t)H * kQ : 0;
  }
  __host__ __device__ size_t av_bytes() const {
    return av_tile ? fb90::round1024((size_t)fb90::kRows * kAvLd * 4) : 0;
  }
  __host__ __device__ size_t ring() const {
    return kWo + q_bytes() + av_bytes();
  }
  __host__ __device__ size_t bytes() const {
    return 1024 + ring() + sm90::kStages * kStage;
  }
};

template <int W, int DW>
__global__ void __launch_bounds__(fb90::kWg) attn_ffn_wgmma_kernel(Params p) {
  using namespace fb90;
  using Cv = FwdCarve<W, DW>;
  constexpr int FC = Cv::kFC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const int D = p.D, H = p.H, hd = D / H, F = p.F, L = p.L, NB = p.NB;
  const int b = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kRows;
  const bool attn = p.av_in == nullptr;
  const Cv cv = Cv::of(H, attn);
  const bool direct = attn && !cv.av_tile;   // av in the accumulator
  bf16* wo_s = reinterpret_cast<bf16*>(base);
  auto q_tile = [&](int h) {
    return reinterpret_cast<bf16*>(base + Cv::kWo +
                                   h * Cv::kQ);
  };
  float* av_s = reinterpret_cast<float*>(base + Cv::kWo + cv.q_bytes());
  auto stage = [&](int s) {
    return base + cv.ring() + (s % sm90::kStages) * Cv::kStage;
  };
  const int n = qt + 1;              // key tiles up to the diagonal
  const int na = attn ? H * n : 0;   // attention steps
  const int nf = (F + FC - 1) / FC;  // FFN chunks, two steps each
  const int steps = na + 2 * nf;
  const size_t rowb = (size_t)b * L;
  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);
  const bf16* W13 = static_cast<const bf16*>(p.w13);
  const bf16* W2 = static_cast<const bf16*>(p.w2);

  // the first group also carries Wo and the query tiles
  load_mat<DW>(wo_s, DW, static_cast<const bf16*>(p.wo), D, D, D);
  if (attn)
    for (int h = 0; h < H; ++h)
      load_mat<W>(q_tile(h), kRows,
                  static_cast<const bf16*>(p.q) + (rowb + q0) * D + h * hd,
                  D, kRows, hd);

  auto issue = [&](int s) {
    if (s < steps) {
      unsigned char* st = stage(s);
      if (s < na) {
        const int h = s / n, kt = s - h * n;
        const size_t r0 = rowb + (size_t)kt * kRows;
        attn_issue<W, false>(
            reinterpret_cast<bf16*>(st), reinterpret_cast<bf16*>(st + Cv::kQ),
            st + Cv::kTiles, K + r0 * D + h * hd, V + r0 * D + h * hd,
            p.valid + r0, p.rab + (size_t)h * NB, D, hd, L - kt * kRows,
            q0 - kt * kRows, NB);
      } else {
        const int j0 = ((s - na) >> 1) * FC, w = min(FC, F - j0);
        bf16* t = reinterpret_cast<bf16*>(st);
        if (((s - na) & 1) == 0) {   // x1 and x3 slices of W13
          load_mat<FC>(t, DW, W13 + j0, 2 * F, D, w);
          load_mat<FC>(reinterpret_cast<bf16*>(st + Cv::kW13), DW,
                       W13 + F + j0, 2 * F, D, w);
        } else {                     // W2 rows of the chunk
          load_mat<DW>(t, FC, W2 + (size_t)j0 * D, D, w, D);
        }
      }
    }
    sm90::cp_async_commit();
  };

  // av, then y, then the output sum; defined by the attention's last step
  // (direct) or at the post half's start (from the av tile or av_in)
  float y[DW / 2];
  float s[32], acc[W / 2];
  const int r0 = acc_row(0), c0 = acc_col(0);
  uint32_t h2a[DW / 16][4], fa[FC / 16][4];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;
  const uint32_t key1 = drop_key(seed, 2u * b);
  const uint32_t key2 = drop_key(seed, 2u * b + 1u);

  issue(0);
  for (int step = 0; step < steps; ++step) {
    issue(step + 1);
    sm90::cp_async_wait<1>();
    sm90::fence_async_smem();
    unsigned char* st = stage(step);
    if (step < na) {
      // --- attention: head h, key tile kt ---
      const int h = step / n, kt = step - h * n;
      attn_step<W>(acc, s, q_tile(h), reinterpret_cast<bf16*>(st),
                   reinterpret_cast<bf16*>(st + Cv::kQ), st + Cv::kTiles,
                   q0 - kt * kRows, r0, c0, 1.0f);
      if (kt == n - 1) {   // head h is summed
        if constexpr (W == DW && DW <= 64) {
          if (direct) {
#pragma unroll
            for (int i = 0; i < W / 2; ++i) y[i] = acc[i];
          }
        }
        if (!direct) {
#pragma unroll
          for (int i = 0; i < W / 2; i += 2) {
            const int c = acc_col(i);
            if (c < hd)
              *reinterpret_cast<float2*>(av_s + acc_row(i) * Cv::kAvLd +
                                         h * hd + c) =
                  make_float2(acc[i], acc[i + 1]);
          }
        }
#pragma unroll
        for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
      }
    } else {
      __syncthreads();
      const int f = step - na, j0 = (f >> 1) * FC;
      if (f == 0) {
        // --- av in registers, LN2 * u * keep1, y = T(g) Wo + x + bo ---
        const size_t row0 = rowb + q0;
        if (!attn) {
#pragma unroll
          for (int i = 0; i < DW / 2; i += 2) {
            const float2 v = ld_bf16x2(
                static_cast<const bf16*>(p.av_in) + row0 * D, D, i, D);
            y[i] = v.x;
            y[i + 1] = v.y;
          }
        } else if (!direct) {
#pragma unroll
          for (int i = 0; i < DW / 2; i += 2) {
            const int c = acc_col(i);
            const float2 v = c < D ? *reinterpret_cast<const float2*>(
                                         av_s + acc_row(i) * Cv::kAvLd + c)
                                   : make_float2(0.0f, 0.0f);
            y[i] = v.x;
            y[i + 1] = v.y;
          }
        }
        if (p.round_av) {
#pragma unroll
          for (int i = 0; i < DW / 2; ++i) y[i] = round_bf16(y[i]);
        }
        if (p.av) st_bf16(static_cast<bf16*>(p.av) + row0 * D, D, y, D);
        float mu[2], rs[2];
        row_stats(y, D, mu, rs);
        const float* g2 = p.ln + 2 * D;
        const float* b2 = p.ln + 3 * D;
        const float* u = p.u + row0 * D;
        float g[DW / 2];
#pragma unroll
        for (int i = 0; i < DW / 2; i += 2) {
          const int hf = (i >> 1) & 1, r = acc_row(i), c = acc_col(i);
          const float2 gg = ld_vec2(g2, i, D), bb = ld_vec2(b2, i, D);
          const float2 uu = ld_f32x2(u, D, i, D);
          g[i] = ((y[i] - mu[hf]) * rs[hf] * gg.x + bb.x) * uu.x;
          g[i + 1] = ((y[i + 1] - mu[hf]) * rs[hf] * gg.y + bb.y) * uu.y;
          if (drop) {
            const uint32_t cnt = (uint32_t)((q0 + r) * D + c);
            g[i] *= keep_factor(key1, cnt, p.thr, p.keep_scale);
            g[i + 1] *= keep_factor(key1, cnt + 1u, p.thr, p.keep_scale);
          }
        }
        uint32_t ga[DW / 16][4];
        frags(g, ga);
        sm90::wgmma_fence();
        chain<DW, 1>(y, ga, [&](int kk) {
          return Tile<DW>::desc_mn(wo_s, DW, kk);
        }, false);
        finish(y);
        const bf16* x = static_cast<const bf16*>(p.x) + row0 * D;
#pragma unroll
        for (int i = 0; i < DW / 2; i += 2) {
          const float2 xv = ld_bf16x2(x, D, i, D), bv = ld_vec2(p.bo, i, D);
          y[i] += xv.x + bv.x;
          y[i + 1] += xv.y + bv.y;
        }
        row_stats(y, D, mu, rs);
        const float* g3 = p.ln + 4 * D;
        const float* b3 = p.ln + 5 * D;
#pragma unroll
        for (int i = 0; i < DW / 2; i += 2) {
          const int hf = (i >> 1) & 1;
          const float2 gg = ld_vec2(g3, i, D), bb = ld_vec2(b3, i, D);
          g[i] = (y[i] - mu[hf]) * rs[hf] * gg.x + bb.x;
          g[i + 1] = (y[i + 1] - mu[hf]) * rs[hf] * gg.y + bb.y;
        }
        frags(g, h2a);
      }
      if ((f & 1) == 0) {
        // --- [x1 | x3] = T(LN3(y)) W13[chunk]; f = silu(x1) x3 keep2 ---
        float x1[FC / 2], x3[FC / 2];
        const bf16* wa = reinterpret_cast<const bf16*>(st);
        const bf16* wb = reinterpret_cast<const bf16*>(st +
                                                       Cv::kW13);
        sm90::wgmma_fence();
        chain<FC, 1>(x1, h2a, [&](int kk) {
          return Tile<FC>::desc_mn(wa, DW, kk);
        }, false);
        chain<FC, 1>(x3, h2a, [&](int kk) {
          return Tile<FC>::desc_mn(wb, DW, kk);
        }, false);
        finish(x1);
        sm90::reg_fence(x3);
#pragma unroll
        for (int i = 0; i < FC / 2; ++i) {
          float fv = fast_silu(x1[i]) * x3[i];
          if (drop)
            fv *= keep_factor(key2, (uint32_t)((q0 + acc_row(i)) * F + j0 +
                                               acc_col(i)),
                              p.thr, p.keep_scale);
          x1[i] = fv;
        }
        frags(x1, fa);
      } else {
        // --- out += T(f) W2[chunk], onto y ---
        const bf16* w2s = reinterpret_cast<const bf16*>(st);
        sm90::wgmma_fence();
        chain<DW, 1>(y, fa, [&](int kk) {
          return Tile<DW>::desc_mn(w2s, FC, kk);
        }, true);
        finish(y);
      }
    }
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  st_bf16(static_cast<bf16*>(p.out) + (rowb + q0) * D, D, y, D);
}

// Whether bf16 operands of this shape take attn_ffn_wgmma_kernel: D at
// most 128 and head slices (with attention) in whole 16-byte chunks.
inline bool attn_ffn_wgmma_shape(const Params& p, bool attn) {
  return fb90::post_width(p.D) != 0 && (!attn || fb90::attn_heads(p.D, p.H));
}

template <int W, int DW>
int launch_attn_ffn_wgmma(const Params& p, cudaStream_t stream) {
  // the operands it streams with cp.async: a misaligned one fails the
  // launch (the wrapper checks every operand's alignment)
  if (!sm90::aligned16(p.wo) || !sm90::aligned16(p.w13) ||
      !sm90::aligned16(p.w2) ||
      (p.av_in == nullptr && (!sm90::aligned16(p.q) ||
                              !sm90::aligned16(p.k) ||
                              !sm90::aligned16(p.v))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = FwdCarve<W, DW>::of(p.H, p.av_in == nullptr).bytes();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_ffn_wgmma_kernel<W, DW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_ffn_wgmma_kernel<W, DW>
      <<<dim3(p.L / fb90::kRows, p.B), fb90::kWg, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DW>
int launch_attn_ffn_dw(const Params& p, cudaStream_t stream) {
  // the post stage alone runs no attention: any head width will do
  const int W = p.av_in ? 16 : sm90::wgmma_width(p.D / p.H);
  if constexpr (DW >= 128)
    if (W == 128) return launch_attn_ffn_wgmma<128, DW>(p, stream);
  if constexpr (DW >= 64)
    if (W == 64) return launch_attn_ffn_wgmma<64, DW>(p, stream);
  if (W == 32) return launch_attn_ffn_wgmma<32, DW>(p, stream);
  if (W == 16) return launch_attn_ffn_wgmma<16, DW>(p, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_attn_ffn_wgmma_any(const Params& p, cudaStream_t stream) {
  switch (fb90::post_width(p.D)) {
    case 32: return launch_attn_ffn_dw<32>(p, stream);
    case 64: return launch_attn_ffn_dw<64>(p, stream);
    default: return launch_attn_ffn_dw<128>(p, stream);
  }
}

// ===========================================================================
// proj_wgmma_kernel: LN1 and the projection, the bf16 instance on wgmma
// ===========================================================================
//
// The same function as proj_kernel, for bf16 at D <= 128 (padded to DW = 32,
// 64 or 128 columns): the whole-sequence and chunked forward's first stage
// and the ring's stage 0. Persistent blocks of one warpgroup, four to an SM
// at DW <= 64, stride over the 64-token tiles. Per tile, in registers: x's
// rows (8-byte loads); LN1 in the accumulator layout (quad shuffles, the
// function gate_ffn_bwd_wgmma_kernel recomputes with) into T(h1)'s A
// fragments; per slice k of Wuvqk (u, v, q, k) pre = T(h1) W_k (RS wgmma,
// W_k an MN-major B), then silu(pre + b_k) times 1, 1/L, hd^-1/2 or 1,
// stored straight from registers: u in f32 (16-byte stores), v, q and k in
// bf16 (8-byte stores). Wuvqk stays in shared memory at DW <= 64 (8 or 32
// KB, loaded once per block); at DW = 128 (32 KB a slice) the slices stream
// through the two-stage cp.async ring.
//
// Bound: memory. At the flagship (B=128, L=1024, D=64) x in and q, k, v, u
// out are 101 MB (30 us at 3.35 TB/s) against 4.3 GFLOP (4.3 us): the
// products are small, so the design keeps every value in registers, reads
// x once and writes each output once with whole 32-byte sectors per row.
// Four blocks an SM (registers capped at 128, 124 used at DW = 64) hide the
// loads' latency better than three that load x one tile ahead (PERF.md).
template <int DW>
__global__ void __launch_bounds__(fb90::kWg, DW <= 64 ? 4 : 1)
    proj_wgmma_kernel(Params p) {
  using namespace fb90;
  constexpr int NF = DW / 2;
  extern __shared__ unsigned char smem_raw[];
  const int D = p.D;
  const int ntiles = p.B * (p.L / kRows);
  const int mine = (int)blockIdx.x < ntiles
                       ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const bf16* X = static_cast<const bf16*>(p.x);
  const WuvqkSlices<DW> ws{sm90::align1024(smem_raw),
                           static_cast<const bf16*>(p.wuvqk), D, 4 * mine};
  ws.start();

  for (int ti = 0; ti < mine; ++ti) {
    const size_t row0 = ((size_t)blockIdx.x + (size_t)ti * gridDim.x) * kRows;
    uint32_t h1a[DW / 16][4];
    {
      uint32_t xr[NF / 2];
      float mu[2], rs[2];
      ld_pairs(X + row0 * D, D, D, xr);
      ln1<DW>(xr, p.ln, D, h1a, mu, rs);
    }
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const int s = 4 * ti + k;
      float pre[NF];
      proj_slice<DW>(pre, h1a, ws.acquire(s));
      ws.release();
      silu_bias(pre, p.buvqk + k * D, D,
                k == 1 ? p.inv_len : k == 2 ? p.scale : 1.0f);
      if (k == 0) {
        st_f32_q(p.u + row0 * D, D, D, pre);
      } else {
        void* out = k == 1 ? p.v : k == 2 ? p.q : p.k;
        st_bf16_q(static_cast<bf16*>(out) + row0 * D, D, D, pre);
      }
    }
  }
}

// Which instance of the projection runs: proj_wgmma_kernel in bf16 at D <=
// 128 (every fused preset), proj_kernel in f32 (the tight check instance)
// and at D > 128. The Python predicate ops/fused_block.block_wgmma states
// the same rule for the backward.
inline bool proj_wgmma_route(const Params& p, bool is_bf16) {
  return is_bf16 && fb90::post_width(p.D) != 0;
}

template <int DW>
int launch_proj_wgmma(const Params& p, cudaStream_t stream) {
  // its 8- and 16-byte accesses and cp.async: a misaligned operand fails
  // the launch (the wrapper checks every operand's alignment)
  if (!sm90::aligned16(p.x) || !sm90::aligned16(p.wuvqk) ||
      !sm90::aligned16(p.q) || !sm90::aligned16(p.k) ||
      !sm90::aligned16(p.v) || !sm90::aligned16(p.u))
    return (int)cudaErrorInvalidValue;
  return fb90::launch_persistent(proj_wgmma_kernel<DW>,
                                 1024 + fb90::WuvqkSlices<DW>::kBytes,
                                 p.B * (p.L / fb90::kRows), stream, p);
}

int launch_proj_wgmma_any(const Params& p, cudaStream_t stream) {
  switch (fb90::post_width(p.D)) {
    case 32: return launch_proj_wgmma<32>(p, stream);
    case 64: return launch_proj_wgmma<64>(p, stream);
    default: return launch_proj_wgmma<128>(p, stream);
  }
}

template <typename T>
int launch_proj(const Params& p, bool tc, cudaStream_t stream) {
  const size_t sm = proj_smem<T>(p.D);
  if (sm > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return (int)e;
  proj_kernel<T><<<dim3(p.L / kTM, p.B), kThreads, sm, stream>>>(p, tc);
  return (int)cudaGetLastError();
}

// stages: 1 = the projection, 2 = the attention and post half, 3 = both (the
// whole block). Which instance runs where: bf16 at D <= 128 (every fused
// preset, the whole-sequence and chunked forward and the ring's stages)
// takes proj_wgmma_kernel (proj_wgmma_route) and attn_ffn_wgmma_kernel; f32
// (the tight check instance) and D > 128 take proj_kernel and
// attn_ffn_kernel (WMMA through shared memory in bf16, FMA loops in f32). A
// choice by dtype and shape, made here alone: a launch the chosen instance
// cannot make fails, and the wrapper raises.
template <typename T>
int launch(const Params& p, bool tc, cudaStream_t stream, int stages) {
  const bool is_bf16 = std::is_same<T, bf16>::value;
  if (stages & 1) {
    const int e = proj_wgmma_route(p, is_bf16)
                      ? launch_proj_wgmma_any(p, stream)
                      : launch_proj<T>(p, tc, stream);
    if (e != 0) return e;
  }
  if (!(stages & 2)) return 0;
  if (is_bf16 && attn_ffn_wgmma_shape(p, p.av_in == nullptr))
    return launch_attn_ffn_wgmma_any(p, stream);
  int TQ = 0;
  for (int t = 64; t >= 16; t >>= 1) {
    if (p.L % t == 0 && attn_smem<T>(p.D, t) <= kMaxSmem) {
      TQ = t;
      break;
    }
  }
  if (TQ == 0) return (int)cudaErrorInvalidValue;
  const size_t sm_b = attn_smem<T>(p.D, TQ);
  cudaError_t e = cudaFuncSetAttribute(
      attn_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_b);
  if (e != cudaSuccess) return (int)e;
  attn_ffn_kernel<T><<<dim3(p.L / TQ, p.B), kThreads, sm_b, stream>>>(
      p, TQ, tc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: x/out [B, L, D], valid
// [B, L] int32, ln [6, D] f32, wuvqk [D, 4D], buvqk [4D] f32, wo [D, D],
// bo [D] f32, w13 [D, 2F], w2 [F, D], rab [H, NB] f32, scratch q/k/v
// [B, L, D] in the compute dtype and u [B, L, D] f32. Training: av [B, L, D]
// in the compute dtype (null in inference) and, for dropout, seed [1] int32
// on the device with the keep threshold thr = uint32(p * 2^32) and
// keep_scale = 1 / (1 - p) (seed null: no dropout). round_av nonzero selects
// the chunked variant's rounding point. All contiguous, 16-byte aligned.
// Requires L % 64 == 0, D % 16 == 0, F % 16 == 0, D % H == 0. Each returns a
// cudaError_t code (0 on success).
static int run(int is_bf16, const void* x, const void* valid, const void* ln,
               const void* wuvqk, const void* buvqk, const void* wo,
               const void* bo, const void* w13, const void* w2,
               const void* rab, void* q, void* k, void* v, void* u, void* out,
               void* av, const void* av_in, const void* seed, int B, int L,
               int D, int H, int F, int NB, int round_av, float scale,
               float inv_len, unsigned thr, float keep_scale, void* stream,
               int stages) {
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
  p.av = av;
  p.av_in = av_in;
  p.seed = static_cast<const int*>(seed);
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.F = F;
  p.NB = NB;
  p.round_av = round_av;
  p.scale = scale;
  p.inv_len = inv_len;
  p.thr = thr;
  p.keep_scale = keep_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(p, true, s, stages);
  return launch<float>(p, false, s, stages);
}

// The whole block: the projection, then the second kernel.
extern "C" int fused_block_fwd(int is_bf16, const void* x, const void* valid,
                               const void* ln, const void* wuvqk,
                               const void* buvqk, const void* wo,
                               const void* bo, const void* w13,
                               const void* w2, const void* rab, void* q,
                               void* k, void* v, void* u, void* out, void* av,
                               const void* seed, int B, int L, int D, int H,
                               int F, int NB, int round_av, float scale,
                               float inv_len, unsigned thr, float keep_scale,
                               void* stream) {
  return run(is_bf16, x, valid, ln, wuvqk, buvqk, wo, bo, w13, w2, rab, q, k,
             v, u, out, av, nullptr, seed, B, L, D, H, F, NB, round_av, scale,
             inv_len, thr, keep_scale, stream, 3);
}

// One stage of a sequence-sharded ring (ops/fused_block.ring_pre_fwd,
// ring_post_fwd), on a shard of L tokens: stage 0 runs the projection alone
// (replacing _fwd_pre_kernel_chunk, l.452, as ring_pre_proj launches it;
// inv_len is 1 / the whole sequence's length); stage 1 runs
// the second kernel's post half alone on the attention output av_in (in T),
// replacing _fwd_post_kernel_chunk (l.502) as ring_post_gate launches it.
// Pointers a stage does not read may be null.
extern "C" int fused_block_stage(int is_bf16, int stage, const void* x,
                                 const void* ln, const void* wuvqk,
                                 const void* buvqk, const void* wo,
                                 const void* bo, const void* w13,
                                 const void* w2, void* q, void* k, void* v,
                                 void* u, void* out, const void* av_in,
                                 const void* seed, int B, int L, int D, int H,
                                 int F, float scale, float inv_len,
                                 unsigned thr, float keep_scale,
                                 void* stream) {
  if (stage != 0 && (stage != 1 || av_in == nullptr))
    return (int)cudaErrorInvalidValue;
  return run(is_bf16, x, nullptr, ln, wuvqk, buvqk, wo, bo, w13, w2, nullptr,
             q, k, v, u, out, nullptr, av_in, seed, B, L, D, H, F, 1, 0, scale,
             inv_len, thr, keep_scale, stream, stage == 0 ? 1 : 2);
}
