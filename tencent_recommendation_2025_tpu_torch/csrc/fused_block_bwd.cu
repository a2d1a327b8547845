// Fused pre-norm HSTU block backward for Hopper, sm_90a.
//
// Replaces tencent_recommendation_2025_tpu/ops/fused_block.py::_bwd_kernel
// (l.325, the whole-sequence Pallas backward). Inputs are the forward's x,
// its attention output av (in the compute dtype T, written by the training
// forward in fused_block.cu) and dout, all [B, L, D]; outputs dx [B, L, D]
// in T and, in f32, the gradients of the LN pack [6, D], Wuvqk [D, 4D],
// buvqk [4D], Wo [D, D], bo [D], W13 [D, 2F], W2 [F, D] and rab [H, NB].
// Per token, as the TPU kernel computes it:
//
//   recompute: h1 = LN1(x); pre = T(h1) Wuvqk + b; u, v, q, k from silu(pre);
//              LN2 from the rounded av; g = LN2(av) u keep1; y = x + T(g) Wo
//              + bo; [x1 | x3] = T(LN3(y)) W13; f = silu(x1) x3 keep2
//   dW2 = T(f)^T T(dout); df = T(dout) W2^T keep2;
//   dx13 = T([df x3 dsilu(x1) | df silu(x1)]); dW13 = T(h2)^T dx13;
//   dh2 = dx13 W13^T; dy = dout + LN3'(dh2); dWo = T(g)^T T(dy); dbo = sum dy;
//   dg = T(dy) Wo^T keep1; du = dg LN2(av); dav = LN2'(dg u);
//   attention, per head with dot_b = T(dav): a = T(silu(s)) on causal valid
//   pairs; dv = a^T dot_b; ds = (dot_b v^T) dsilu(s) on those pairs;
//   dq = T(ds) k hd^-1/2; dk = T(ds)^T q; drab[h, min(q-k, NB-1)] += ds;
//   duvqk = [du, dv / L, dq, dk] dsilu(pre); dWuvqk = T(h1)^T T(duvqk);
//   dbuvqk = sum duvqk; dx = T(dy + LN1'(T(duvqk) Wuvqk^T)).
//
// The rounding points are the TPU kernel's (dout, dx13, dy, dav, ds and
// duvqk rounded to T where they are product operands; everything
// elementwise in f32), so the plain version
// (ops/fused_block.fused_hstu_block_bwd_plain) agrees to summation order
// and bf16 disagreements stay single flips. Dropout masks are regenerated
// from the counter hash of fused_block_common.cuh.
//
// Design. The TPU kernel runs a sequential grid (B,) over one batch row's
// whole [D, L] sequence in VMEM and accumulates the weight gradients in
// revisited output blocks. Hopper blocks run in parallel, so the work is
// split at the keys, the only all-to-all dependency, into four steps:
//   gate_ffn_bwd   G blocks striding over 64-token tiles: the recompute, the
//                  FFN, out-projection and gate backward; writes q, k, v,
//                  T(dav) and du, dy (f32) to a scratch;
//   attention      the HSTU attention backward of csrc/hstu_attn_bwd_sm90.cuh
//                  at off 0 and Lq = Lk = L, the kernels the ring's pairs
//                  launch too: dq (times hd^-1/2) with the rel-pos gradient
//                  summed per diagonal of each tile into per-(query tile,
//                  row) partials, then dk and dv (wgmma kernels in bf16 at
//                  hd <= 128, the generic ones in f32 and at wider heads);
//   proj_bwd       G blocks striding over token tiles: the projection and
//                  LN1 backward, plus the residual, writing dx.
// Weight, LN and bias gradients accumulate into a per-block slice of a
// partial-sum buffer ([G, P] f32); a last pass (reduce_rows) sums the slices
// in a fixed order, as it sums the rel-pos partials. No atomics: the result
// is deterministic.
//
// In bf16 at D <= 128 (every fused preset) step 1 is
// gate_ffn_bwd_wgmma_kernel and step 3 proj_bwd_wgmma_kernel (below, on
// csrc/fused_block_sm90.cuh): wgmma with register accumulators, and the
// weight products dW2, dW13, dWo and dWuvqk taken over token ranges from
// bf16 scratch by wgrad_wgmma_kernel instead of an f32 read-modify-write of
// ``part`` per tile.
//
// Bound on the H100 at the flagship shape (B=128, L=1024, D=64, F=256,
// H=1), per block: 93.46 GFLOP of products (recompute: projection 4.29,
// s 8.60, Wo 1.07, W13 8.59; attention dv, da, dq, dk 8.60 each; weight
// products twice each, dW and dX: projection 8.59, Wo 2.15, W13 17.18, W2
// 8.59), 94.5 us at 989 TFLOP/s bf16, against 67 MB of x, av, dout and dx
// (20 us at 3.35 TB/s): compute bound. gate_ffn_bwd and proj_bwd, where
// they run (f32, D > 128), run their products as WMMA tiles (bf16, f32
// accumulators) through shared memory, FMA loops in f32.

#include "fused_block_common.cuh"
#include "fused_block_sm90.cuh"
#include "hstu_attn_bwd_sm90.cuh"

using namespace fbk;

// The backward's arguments; the wrapper (ops/fused_block._BwdArgs) mirrors
// this struct field for field.
struct BwdArgs {
  // inputs
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
  const void* av;      // [B, L, D] T
  const void* dout;    // [B, L, D] T
  const int* seed;     // [1] dropout seed, or null: no dropout
  // scratch, allocated by the wrapper
  void* q;             // [B, L, D] T, scaled by hd^-1/2
  void* k;             // [B, L, D] T
  void* v;             // [B, L, D] T, scaled by 1/L
  void* dav;           // [B, L, D] T
  float* du;           // [B, L, D]
  float* dy;           // [B, L, D]; the projection backward's residual, or
                       // null: none (the ring's stage 1)
  float* dv;           // [B, L, D], w.r.t. the scaled v
  float* dq;           // [B, L, D], times hd^-1/2 (dq_scale 1)
  float* dk;           // [B, L, D]; dv, dq, dk in T where cot_t
  float* part;         // [G, P] zeroed: per-block partial sums
  float* part_rab;     // [B * L / 16, H * NB]: per-(query tile, row) partials
  // outputs
  void* dx;            // [B, L, D] T
  float* grads;        // [P]: dW2, dW13, dWo, dbo, dln, dWuvqk, dbuvqk
  float* drab;         // [H, NB]
  // scratch of the wgmma gate/FFN kernel, whose presence selects it (the
  // wrapper passes it in bf16 at D <= 128; else null): the bf16 operands of
  // the weight-gradient products over tokens
  void* fs;            // [B, L, F] T(f)
  void* dx13s;         // [B, L, 2F] T([dx1 | dx3])
  void* h2s;           // [B, L, D] T(LN3(y))
  void* gs;            // [B, L, D] T(g)
  void* dys;           // [B, L, D] T(dy)
  // scratch of the wgmma projection backward, whose presence selects it
  // (likewise): the operands of dWuvqk's product over tokens
  void* h1s;           // [B, L, D] T(LN1(x))
  void* duvqks;        // [B, L, 4D] T(duvqk)
  float* psum;         // [B L / 64, 6D]: per tile, dbuvqk ([.., 4D] rows),
                       // then LN1's gamma and beta ([.., 2D] rows)
  int B, L, D, H, F, NB;
  int G, P;            // blocks of the striding kernels; partial row width
  int off_w2, off_w13, off_wo, off_bo, off_ln, off_wuvqk, off_buvqk;
  int cot_t;           // dv, dq, dk in T (the ring's stage 1), else f32
  float scale, inv_len;
  float dq_scale;      // dq's factor before dsilu: 1, or hd^-1/2 (stage 1)
  unsigned thr;        // dropout: keep iff bits >= thr
  float keep_scale;    // dropout: 1 / (1 - p)
};

namespace {

// mean over a row of (g * gamma) and of (g * gamma * xhat), one warp
template <typename XHat>
__device__ __forceinline__ void ln_bwd_means(const float* g,
                                             const float* gamma, XHat xhat,
                                             int D, float& m1, float& m2) {
  const int lane = threadIdx.x & 31;
  float s1 = 0.0f, s2 = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float t = g[d] * gamma[d];
    s1 += t;
    s2 += t * xhat(d);
  }
  m1 = warp_sum(s1) / D;
  m2 = warp_sum(s2) / D;
}

template <typename T>
size_t gate_smem(int D, int TM) {
  const size_t tt = align128((size_t)TM * (D + 8) * sizeof(T));
  const size_t tp = align128((size_t)TM * kLdP * sizeof(T));
  const size_t tf = align128((size_t)TM * (D + 4) * sizeof(float));
  const size_t tc = align128((size_t)TM * kLdS * sizeof(float));
  return 3 * tt + 3 * tp + 3 * tf + 3 * tc + 6 * align128(TM * sizeof(float));
}

// Step 1: recompute, then the backward through the FFN, the out-projection
// and the gate, per TM-token tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_ffn_bwd_kernel(BwdArgs p, int TM, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, L = p.L;
  const int ldt = D + 8, ldf = D + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  unsigned char* ptr = smem;
  const size_t tt = align128((size_t)TM * ldt * sizeof(T));
  const size_t tp = align128((size_t)TM * kLdP * sizeof(T));
  const size_t tf = align128((size_t)TM * ldf * sizeof(float));
  const size_t tcs = align128((size_t)TM * kLdS * sizeof(float));
  T* hs = reinterpret_cast<T*>(ptr);    // T(LN1(x)), then T(g)
  ptr += tt;
  T* h2 = reinterpret_cast<T*>(ptr);    // T(LN3(y))
  ptr += tt;
  T* dos = reinterpret_cast<T*>(ptr);   // dout, then T(dy)
  ptr += tt;
  T* fcs = reinterpret_cast<T*>(ptr);   // T(f) chunk
  ptr += tp;
  T* dx1s = reinterpret_cast<T*>(ptr);  // T(dx1) chunk
  ptr += tp;
  T* dx3s = reinterpret_cast<T*>(ptr);  // T(dx3) chunk
  ptr += tp;
  float* us = reinterpret_cast<float*>(ptr);   // u
  ptr += tf;
  float* ys = reinterpret_cast<float*>(ptr);   // y, then dg, then xhat2
  ptr += tf;
  float* dh2 = reinterpret_cast<float*>(ptr);  // dh2, then dy, then dav_ln
  ptr += tf;
  float* c1 = reinterpret_cast<float*>(ptr);   // projection chunk; x1
  ptr += tcs;
  float* c2 = reinterpret_cast<float*>(ptr);   // x3
  ptr += tcs;
  float* c3 = reinterpret_cast<float*>(ptr);   // df
  ptr += tcs;
  float* mu1 = reinterpret_cast<float*>(ptr);
  ptr += align128(TM * sizeof(float));
  float* rs1 = reinterpret_cast<float*>(ptr);
  ptr += align128(TM * sizeof(float));
  float* mu2 = reinterpret_cast<float*>(ptr);
  ptr += align128(TM * sizeof(float));
  float* rs2 = reinterpret_cast<float*>(ptr);
  ptr += align128(TM * sizeof(float));
  float* mu3 = reinterpret_cast<float*>(ptr);
  ptr += align128(TM * sizeof(float));
  float* rs3 = reinterpret_cast<float*>(ptr);

  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;
  const T* wuvqk = static_cast<const T*>(p.wuvqk);
  const T* wo = static_cast<const T*>(p.wo);
  const T* w13 = static_cast<const T*>(p.w13);
  const T* w2 = static_cast<const T*>(p.w2);
  const float* g1 = p.ln;
  const float* b1 = p.ln + D;
  const float* g2 = p.ln + 2 * D;
  const float* b2 = p.ln + 3 * D;
  const float* g3 = p.ln + 4 * D;
  const float* b3 = p.ln + 5 * D;
  float* part = p.part + (size_t)blockIdx.x * p.P;
  const int per_row = L / TM;

  for (int tile = blockIdx.x; tile < p.B * per_row; tile += gridDim.x) {
    const int b = tile / per_row, t0 = (tile - b * per_row) * TM;
    const size_t row0 = (size_t)b * L + t0;
    const T* x = static_cast<const T*>(p.x) + row0 * D;
    const T* av = static_cast<const T*>(p.av) + row0 * D;
    const uint32_t key1 = drop_key(seed, 2u * b);
    const uint32_t key2 = drop_key(seed, 2u * b + 1u);

    // --- recompute: LN1, projection -> u (smem), q, k, v (scratch) ---
    __syncthreads();  // the previous tile is done with every buffer
    row_stats<T>(x, D, TM, D, mu1, rs1);
    row_stats<T>(av, D, TM, D, mu2, rs2);
    __syncthreads();
    for (int i = threadIdx.x; i < TM * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      hs[r * ldt + d] =
          from_f<T>((to_f(x[i]) - mu1[r]) * rs1[r] * g1[d] + b1[d]);
    }
    __syncthreads();
    for (int n0 = 0; n0 < 4 * D; n0 += kNC) {
      gemm<T, false, false, false>(hs, ldt, wuvqk + n0, 4 * D, c1, kLdS, TM,
                                   kNC, D, tc);
      __syncthreads();
      for (int i = threadIdx.x; i < TM * kNC; i += kThreads) {
        const int r = i / kNC, c = i - r * kNC, col = n0 + c;
        const float s = silu(c1[r * kLdS + c] + p.buvqk[col]);
        const int part_i = col / D, d = col - part_i * D;
        const size_t o = (row0 + r) * D + d;
        if (part_i == 0)
          us[r * ldf + d] = s;
        else if (part_i == 1)
          static_cast<T*>(p.v)[o] = from_f<T>(s * p.inv_len);
        else if (part_i == 2)
          static_cast<T*>(p.q)[o] = from_f<T>(s * p.scale);
        else
          static_cast<T*>(p.k)[o] = from_f<T>(s);
      }
      __syncthreads();
    }

    // --- g = LN2(av) * u * keep1 -> T(g) in hs; y = x + T(g) Wo + bo ---
    for (int i = threadIdx.x; i < TM * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float g = ((to_f(av[i]) - mu2[r]) * rs2[r] * g2[d] + b2[d]) *
                us[r * ldf + d];
      if (drop)
        g *= keep_factor(key1, (uint32_t)((t0 + r) * D + d), p.thr,
                         p.keep_scale);
      hs[r * ldt + d] = from_f<T>(g);
    }
    __syncthreads();
    gemm<T, false, false, false>(hs, ldt, wo, D, ys, ldf, TM, D, D, tc);
    __syncthreads();
    for (int i = threadIdx.x; i < TM * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      ys[r * ldf + d] += to_f(x[i]) + p.bo[d];
    }
    __syncthreads();
    row_stats<float>(ys, ldf, TM, D, mu3, rs3);
    __syncthreads();
    load_tile<T>(static_cast<const T*>(p.dout) + row0 * D, TM, D, dos, ldt);
    for (int i = threadIdx.x; i < TM * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      h2[r * ldt + d] =
          from_f<T>((ys[r * ldf + d] - mu3[r]) * rs3[r] * g3[d] + b3[d]);
      dh2[r * ldf + d] = 0.0f;
    }
    __syncthreads();

    // --- SwiGLU FFN backward in F-chunks ---
    for (int j0 = 0; j0 < F; j0 += kNC) {
      const int nc = min(kNC, F - j0);
      gemm<T, false, false, false>(h2, ldt, w13 + j0, 2 * F, c1, kLdS, TM, nc,
                                   D, tc);
      gemm<T, false, false, false>(h2, ldt, w13 + F + j0, 2 * F, c2, kLdS, TM,
                                   nc, D, tc);
      __syncthreads();
      for (int i = threadIdx.x; i < TM * nc; i += kThreads) {
        const int r = i / nc, c = i - r * nc;
        float f = silu(c1[r * kLdS + c]) * c2[r * kLdS + c];
        if (drop)
          f *= keep_factor(key2, (uint32_t)((t0 + r) * F + j0 + c), p.thr,
                           p.keep_scale);
        fcs[r * kLdP + c] = from_f<T>(f);
      }
      __syncthreads();
      // dW2[j0 : j0 + nc] += T(f)^T T(dout);  df = T(dout) W2[j0 : j0+nc]^T
      gemm<T, true, false, true>(fcs, kLdP, dos, ldt,
                                 part + p.off_w2 + (size_t)j0 * D, D, nc, D,
                                 TM, tc);
      gemm<T, false, true, false>(dos, ldt, w2 + (size_t)j0 * D, D, c3, kLdS,
                                  TM, nc, D, tc);
      __syncthreads();
      for (int i = threadIdx.x; i < TM * nc; i += kThreads) {
        const int r = i / nc, c = i - r * nc;
        const float x1 = c1[r * kLdS + c], x3 = c2[r * kLdS + c];
        float df = c3[r * kLdS + c];
        if (drop)
          df *= keep_factor(key2, (uint32_t)((t0 + r) * F + j0 + c), p.thr,
                            p.keep_scale);
        dx1s[r * kLdP + c] = from_f<T>(df * x3 * dsilu(x1));
        dx3s[r * kLdP + c] = from_f<T>(df * silu(x1));
      }
      __syncthreads();
      // dW13 += T(h2)^T dx13;  dh2 += dx13 W13^T
      gemm<T, true, false, true>(h2, ldt, dx1s, kLdP, part + p.off_w13 + j0,
                                 2 * F, D, nc, TM, tc);
      gemm<T, true, false, true>(h2, ldt, dx3s, kLdP,
                                 part + p.off_w13 + F + j0, 2 * F, D, nc, TM,
                                 tc);
      gemm<T, false, true, true>(dx1s, kLdP, w13 + j0, 2 * F, dh2, ldf, TM, D,
                                 nc, tc);
      gemm<T, false, true, true>(dx3s, kLdP, w13 + F + j0, 2 * F, dh2, ldf,
                                 TM, D, nc, tc);
      __syncthreads();
    }

    // --- LN3 backward: its gamma/beta sums, then dy = dout + LN3'(dh2) ---
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < TM; ++r) {
        const float g = dh2[r * ldf + d];
        sg += g * (ys[r * ldf + d] - mu3[r]) * rs3[r];
        sb += g;
      }
      part[p.off_ln + 4 * D + d] += sg;
      part[p.off_ln + 5 * D + d] += sb;
    }
    __syncthreads();
    for (int r = warp; r < TM; r += kWarps) {
      float* g = dh2 + r * ldf;
      const float* yr = ys + r * ldf;
      const float m = mu3[r], rs = rs3[r];
      float m1, m2;
      ln_bwd_means(g, g3, [&](int d) { return (yr[d] - m) * rs; }, D, m1,
                   m2);
      for (int d = lane; d < D; d += 32) {
        const float xh = (yr[d] - m) * rs;
        const float dyv = to_f(dos[r * ldt + d]) +
                          rs * (g[d] * g3[d] - m1 - xh * m2);
        g[d] = dyv;
        p.dy[(row0 + r) * D + d] = dyv;
        dos[r * ldt + d] = from_f<T>(dyv);
      }
    }
    __syncthreads();

    // --- dbo, dWo += T(g)^T T(dy), dg = T(dy) Wo^T into ys ---
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < TM; ++r) s += dh2[r * ldf + d];
      part[p.off_bo + d] += s;
    }
    gemm<T, true, false, true>(hs, ldt, dos, ldt, part + p.off_wo, D, D, D,
                               TM, tc);
    gemm<T, false, true, false>(dos, ldt, wo, D, ys, ldf, TM, D, D, tc);
    __syncthreads();

    // --- gate backward: du = dg LN2(av), dav_ln = dg u (into dh2) ---
    for (int i = threadIdx.x; i < TM * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float dg = ys[r * ldf + d];
      if (drop)
        dg *= keep_factor(key1, (uint32_t)((t0 + r) * D + d), p.thr,
                          p.keep_scale);
      const float xh = (to_f(av[i]) - mu2[r]) * rs2[r];
      p.du[(row0 + r) * D + d] = dg * (xh * g2[d] + b2[d]);
      dh2[r * ldf + d] = dg * us[r * ldf + d];
      ys[r * ldf + d] = xh;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < TM; ++r) {
        sg += dh2[r * ldf + d] * ys[r * ldf + d];
        sb += dh2[r * ldf + d];
      }
      part[p.off_ln + 2 * D + d] += sg;
      part[p.off_ln + 3 * D + d] += sb;
    }
    // LN2 backward -> T(dav), the attention backward's operand
    for (int r = warp; r < TM; r += kWarps) {
      const float* g = dh2 + r * ldf;
      const float* xr = ys + r * ldf;
      float m1, m2;
      ln_bwd_means(g, g2, [&](int d) { return xr[d]; }, D, m1, m2);
      for (int d = lane; d < D; d += 32)
        static_cast<T*>(p.dav)[(row0 + r) * D + d] =
            from_f<T>(rs2[r] * (g[d] * g2[d] - m1 - xr[d] * m2));
    }
  }
}

template <typename T>
size_t proj_bwd_smem(int D, int TM) {
  return align128((size_t)TM * (D + 8) * sizeof(T))        // T(h1)
         + align128((size_t)TM * kLdS * sizeof(float))      // chunk
         + align128((size_t)TM * kLdP * sizeof(T))          // T(duvqk) chunk
         + align128((size_t)TM * (D + 4) * sizeof(float))   // dh1
         + 2 * align128(TM * sizeof(float));
}

// Element o of the cotangent v: in T where in_t (the ring's stage 1), else
// f32.
template <typename T>
__device__ __forceinline__ float cot_at(const float* v, size_t o, int in_t) {
  return in_t ? to_f(reinterpret_cast<const T*>(v)[o]) : v[o];
}

// Step 3: the projection and LN1 backward plus the residual, per TM-token
// tile: duvqk = [du, dv / L, dq dq_scale, dk] dsilu(pre), dWuvqk, dbuvqk,
// dx.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    proj_bwd_kernel(BwdArgs p, int TM, bool tc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, L = p.L;
  const int ldt = D + 8, ldf = D + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  unsigned char* ptr = smem;
  T* hs = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)TM * ldt * sizeof(T));
  float* cs = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TM * kLdS * sizeof(float));
  T* dcs = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)TM * kLdP * sizeof(T));
  float* dh1 = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TM * ldf * sizeof(float));
  float* mu = reinterpret_cast<float*>(ptr);
  ptr += align128(TM * sizeof(float));
  float* rs = reinterpret_cast<float*>(ptr);

  const T* wuvqk = static_cast<const T*>(p.wuvqk);
  const float* g1 = p.ln;
  const float* b1 = p.ln + D;
  float* part = p.part + (size_t)blockIdx.x * p.P;
  const int per_row = L / TM;

  for (int tile = blockIdx.x; tile < p.B * per_row; tile += gridDim.x) {
    const int b = tile / per_row, t0 = (tile - b * per_row) * TM;
    const size_t row0 = (size_t)b * L + t0;
    const T* x = static_cast<const T*>(p.x) + row0 * D;

    __syncthreads();  // the previous tile is done with every buffer
    row_stats<T>(x, D, TM, D, mu, rs);
    __syncthreads();
    for (int i = threadIdx.x; i < TM * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      hs[r * ldt + d] = from_f<T>((to_f(x[i]) - mu[r]) * rs[r] * g1[d] + b1[d]);
      dh1[r * ldf + d] = 0.0f;
    }
    __syncthreads();
    for (int n0 = 0; n0 < 4 * D; n0 += kNC) {
      gemm<T, false, false, false>(hs, ldt, wuvqk + n0, 4 * D, cs, kLdS, TM,
                                   kNC, D, tc);
      __syncthreads();
      for (int i = threadIdx.x; i < TM * kNC; i += kThreads) {
        const int r = i / kNC, c = i - r * kNC, col = n0 + c;
        const int part_i = col / D, d = col - part_i * D;
        const size_t o = (row0 + r) * D + d;
        const float src =
            part_i == 0   ? p.du[o]
            : part_i == 1 ? cot_at<T>(p.dv, o, p.cot_t) * p.inv_len
            : part_i == 2 ? cot_at<T>(p.dq, o, p.cot_t) * p.dq_scale
                          : cot_at<T>(p.dk, o, p.cot_t);
        const float g = src * dsilu(cs[r * kLdS + c] + p.buvqk[col]);
        cs[r * kLdS + c] = g;
        dcs[r * kLdP + c] = from_f<T>(g);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < kNC; c += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < TM; ++r) s += cs[r * kLdS + c];
        part[p.off_buvqk + n0 + c] += s;
      }
      // dWuvqk[:, n0 : n0 + 64] += T(h1)^T T(duvqk);  dh1 += T(duvqk) W^T
      gemm<T, true, false, true>(hs, ldt, dcs, kLdP, part + p.off_wuvqk + n0,
                                 4 * D, D, kNC, TM, tc);
      gemm<T, false, true, true>(dcs, kLdP, wuvqk + n0, 4 * D, dh1, ldf, TM, D,
                                 kNC, tc);
      __syncthreads();
    }

    // --- LN1 backward: gamma/beta sums, then dx = dy + LN1'(dh1) ---
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < TM; ++r) {
        const float g = dh1[r * ldf + d];
        sg += g * (to_f(x[(size_t)r * D + d]) - mu[r]) * rs[r];
        sb += g;
      }
      part[p.off_ln + d] += sg;
      part[p.off_ln + D + d] += sb;
    }
    for (int r = warp; r < TM; r += kWarps) {
      const float* g = dh1 + r * ldf;
      const T* xr = x + (size_t)r * D;
      const float m = mu[r], rsr = rs[r];
      float m1, m2;
      ln_bwd_means(g, g1, [&](int d) { return (to_f(xr[d]) - m) * rsr; }, D,
                   m1, m2);
      for (int d = lane; d < D; d += 32) {
        const float xh = (to_f(xr[d]) - m) * rsr;
        const size_t o = (row0 + r) * D + d;
        static_cast<T*>(p.dx)[o] = from_f<T>(
            (p.dy ? p.dy[o] : 0.0f) + rsr * (g[d] * g1[d] - m1 - xh * m2));
      }
    }
  }
}

// ===========================================================================
// gate_ffn_bwd_wgmma_kernel and wgrad_wgmma_kernel: the bf16 instance on
// wgmma (csrc/fused_block_sm90.cuh)
// ===========================================================================
//
// The same function as gate_ffn_bwd_kernel, for bf16 at D <= 128 (padded to
// DW = 32, 64 or 128 columns), in two kernels:
//
// - gate_ffn_bwd_wgmma_kernel<DW, FC>: G blocks of one warpgroup stride over
//   the 64-token tiles. Per tile, with register accumulators: LN1 and the
//   projection to u, v, q, k (four RS wgmma, one per D-column slice of
//   Wuvqk; v, q, k written as gate_ffn_bwd_kernel writes them), g = LN2(av)
//   u keep1, y = T(g) Wo + x + bo, LN3, then per FC-chunk df = T(dout)
//   W2[chunk]^T, [x1 | x3] = T(h2) W13[chunk], f, dx13 and dh2 += dx13
//   W13[chunk]^T; last LN3', dy, dg = T(dy) Wo^T, du and LN2' -> T(dav).
//   Wo stays in shared memory; the Wuvqk slices and the W2 and W13 chunks
//   stream through a two-stage cp.async ring whose steps run on from one
//   tile to the next. u and y wait in shared memory, each thread its own
//   elements. The LN and bias column sums add per tile, in a fixed order,
//   into the block's sums, which it writes to its row of ``part`` at the end.
//   The weight products' operands T(f), T(dx13), T(h2), T(g) and T(dy) go to
//   the bf16 scratch of BwdArgs: no f32 read-modify-write per tile.
// - wgrad_wgmma_kernel: dW2 = T(f)^T T(dout), dW13 = T(h2)^T T(dx13) and dWo
//   = T(g)^T T(dy) (and proj_bwd_wgmma_kernel's dWuvqk = T(h1)^T
//   T(duvqk)), products over tokens: one warpgroup per 64 x 64 output tile
//   and range of token tiles, SS wgmma with both operands MN-major (the
//   tokens are the K index), written to the range's row of ``part``;
//   reduce_rows_kernel sums the rows in a fixed order. No atomics anywhere.

template <int DW>
struct GateCarve {
  static constexpr int kFC = fb90::kBwdFC, kCPS = fb90::kBwdCPS;
  static constexpr size_t kWo = (size_t)DW * DW * 2;
  static constexpr size_t kKeep = (size_t)(DW / 2) * fb90::kWg * 4;  // u, y
  // T(LN3(y))'s fragments, read by every chunk
  static constexpr size_t kKeepH2 = (size_t)(DW / 4) * fb90::kWg * 4;
  // the warps' shares [5][4][DW] and the block's sums [5][DW]
  static constexpr size_t kRed = fb90::round1024((size_t)25 * DW * 4);
  // a chunk's tiles: W2 rows (N-major for df), the x1 and x3 slices of W13
  static constexpr size_t kW2 = sm90::Tile<DW>::bytes(kFC);
  static constexpr size_t kW13 = sm90::Tile<kFC>::bytes(DW);
  static constexpr size_t kChunk = kW2 + 2 * kW13;
  static constexpr size_t kTiles =
      fb90::cmax(sm90::Tile<DW>::bytes(DW), kCPS * kChunk);
  static constexpr size_t kRing = kWo + 2 * kKeep + kKeepH2 + kRed;
  static constexpr size_t bytes() {
    return 1024 + kRing + sm90::kStages * kTiles;
  }
};

template <int DW>
__global__ void __launch_bounds__(fb90::kWg)
    gate_ffn_bwd_wgmma_kernel(BwdArgs p) {
  using namespace fb90;
  using Cv = GateCarve<DW>;
  constexpr int NF = DW / 2, FC = Cv::kFC, CPS = Cv::kCPS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const int D = p.D, F = p.F, L = p.L, tid = threadIdx.x;
  bf16* wo_s = reinterpret_cast<bf16*>(base);
  float* u_keep = reinterpret_cast<float*>(base + Cv::kWo);
  // y; during the projection steps T(LN1(x))'s fragments
  float* y_keep = u_keep + NF * kWg;
  uint32_t* h1_keep = reinterpret_cast<uint32_t*>(y_keep);
  uint32_t* h2_keep = reinterpret_cast<uint32_t*>(base + Cv::kWo +
                                                  2 * Cv::kKeep);
  float* wsum = reinterpret_cast<float*>(base + Cv::kWo + 2 * Cv::kKeep +
                                         Cv::kKeepH2);
  float* sums = wsum + 20 * DW;
  auto stage = [&](int s) {
    return base + Cv::kRing + (s % sm90::kStages) * Cv::kTiles;
  };
  const int per_row = L / kRows, ntiles = p.B * per_row;
  const int mine = (int)blockIdx.x < ntiles
                       ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int nfs = (F + FC * CPS - 1) / (FC * CPS);
  // steps of a tile: the four slices of Wuvqk, then CPS chunks of W2 and
  // W13 a step
  const int spt = 4 + nfs;
  const int steps = mine * spt;
  const bf16* WP = static_cast<const bf16*>(p.wuvqk);
  const bf16* W13 = static_cast<const bf16*>(p.w13);
  const bf16* W2 = static_cast<const bf16*>(p.w2);
  const float* g2 = p.ln + 2 * D;
  const float* b2 = p.ln + 3 * D;
  const float* g3 = p.ln + 4 * D;
  const float* b3 = p.ln + 5 * D;
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;

  for (int i = tid; i < 5 * DW; i += kWg) sums[i] = 0.0f;
  load_mat<DW>(wo_s, DW, static_cast<const bf16*>(p.wo), D, D, D);

  auto issue = [&](int s) {
    if (s < steps) {
      unsigned char* st = stage(s);
      const int k = s % spt;
      if (k < 4) {
        load_mat<DW>(reinterpret_cast<bf16*>(st), DW, WP + k * D, 4 * D, D,
                     D);
      } else {
#pragma unroll
        for (int sc = 0; sc < CPS; ++sc) {
          const int j0 = ((k - 4) * CPS + sc) * FC, w = min(FC, F - j0);
          unsigned char* t = st + sc * Cv::kChunk;
          load_mat<DW>(reinterpret_cast<bf16*>(t), FC, W2 + (size_t)j0 * D,
                       D, w, D);
          load_mat<FC>(reinterpret_cast<bf16*>(t + Cv::kW2), DW, W13 + j0,
                       2 * F, D, w);
          load_mat<FC>(reinterpret_cast<bf16*>(t + Cv::kW2 + Cv::kW13), DW,
                       W13 + F + j0, 2 * F, D, w);
        }
      }
    }
    sm90::cp_async_commit();
  };

  float mu2[2], rs2[2], mu3[2], rs3[2];
  float dh2[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) dh2[i] = 0.0f;

  issue(0);
  for (int step = 0; step < steps; ++step) {
    issue(step + 1);
    sm90::cp_async_wait<1>();
    sm90::fence_async_smem();
    __syncthreads();
    const int ti = step / spt, k = step - ti * spt;
    const int tile = blockIdx.x + ti * gridDim.x;
    const int b = tile / per_row, t0 = (tile - b * per_row) * kRows;
    const size_t row0 = (size_t)b * L + t0;
    const bf16* x = static_cast<const bf16*>(p.x) + row0 * D;
    const bf16* av = static_cast<const bf16*>(p.av) + row0 * D;
    const bf16* dout = static_cast<const bf16*>(p.dout) + row0 * D;
    const unsigned char* st = stage(step);
    const uint32_t key1 = drop_key(seed, 2u * b);
    const uint32_t key2 = drop_key(seed, 2u * b + 1u);

    if (k < 4) {
      uint32_t h1a[DW / 16][4];
      if (k == 0) {
        // --- LN1 -> T(h1) fragments (kept); LN2's statistics of av ---
        uint32_t xr[NF / 2];
        float mu1[2], rs1[2];
        ld_pairs(x, D, D, xr);
        ln1<DW>(xr, p.ln, D, h1a, mu1, rs1);
        keep(h1_keep, reinterpret_cast<uint32_t(&)[DW / 4]>(h1a));
        float v[NF];
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const float2 e = ld_bf16x2(av, D, i, D);
          v[i] = e.x;
          v[i + 1] = e.y;
        }
        row_stats(v, D, mu2, rs2);
      } else {
        unkeep(h1_keep, reinterpret_cast<uint32_t(&)[DW / 4]>(h1a));
      }
      // --- projection slice k: u (kept), v / L, q hd^-1/2, k ---
      float pre[NF];
      proj_slice<DW>(pre, h1a, reinterpret_cast<const bf16*>(st));
      silu_bias(pre, p.buvqk + k * D, D,
                k == 1 ? p.inv_len : k == 2 ? p.scale : 1.0f);
      if (k == 0) {
        keep(u_keep, pre);
      } else {
        void* out = k == 1 ? p.v : k == 2 ? p.q : p.k;
        st_bf16(static_cast<bf16*>(out) + row0 * D, D, pre, D);
      }
      if (k == 3) {
        // --- g = LN2(av) u keep1; y = T(g) Wo + x + bo; h2 = T(LN3(y)) ---
        float g[NF];
        unkeep(u_keep, g);
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const int hf = (i >> 1) & 1, r = acc_row(i), c = acc_col(i);
          const float2 e = ld_bf16x2(av, D, i, D);
          const float2 gg = ld_vec2(g2, i, D), bb = ld_vec2(b2, i, D);
          g[i] *= (e.x - mu2[hf]) * rs2[hf] * gg.x + bb.x;
          g[i + 1] *= (e.y - mu2[hf]) * rs2[hf] * gg.y + bb.y;
          if (drop) {
            const uint32_t cnt = (uint32_t)((t0 + r) * D + c);
            g[i] *= keep_factor(key1, cnt, p.thr, p.keep_scale);
            g[i + 1] *= keep_factor(key1, cnt + 1u, p.thr, p.keep_scale);
          }
        }
        st_bf16(static_cast<bf16*>(p.gs) + row0 * D, D, g, D);
        uint32_t ga[DW / 16][4];
        frags(g, ga);
        float y[NF];
        sm90::wgmma_fence();
        chain<DW, 1>(y, ga, [&](int kk) {
          return Tile<DW>::desc_mn(wo_s, DW, kk);
        }, false);
        finish(y);
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const float2 xv = ld_bf16x2(x, D, i, D), bv = ld_vec2(p.bo, i, D);
          y[i] += xv.x + bv.x;
          y[i + 1] += xv.y + bv.y;
        }
        keep(y_keep, y);
        row_stats(y, D, mu3, rs3);
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const int hf = (i >> 1) & 1;
          const float2 gg = ld_vec2(g3, i, D), bb = ld_vec2(b3, i, D);
          y[i] = (y[i] - mu3[hf]) * rs3[hf] * gg.x + bb.x;
          y[i + 1] = (y[i + 1] - mu3[hf]) * rs3[hf] * gg.y + bb.y;
        }
        st_bf16(static_cast<bf16*>(p.h2s) + row0 * D, D, y, D);
        uint32_t h2a[DW / 16][4];
        frags(y, h2a);
        keep(h2_keep, reinterpret_cast<uint32_t(&)[DW / 4]>(h2a));
#pragma unroll
        for (int i = 0; i < NF; ++i) dh2[i] = 0.0f;
      }
    } else {
      // --- per chunk: df = T(dout) W2[chunk]^T (W2's rows the N index),
      // [x1 | x3] = T(h2) W13[chunk]; f, dx13; dh2 += dx13 W13[chunk]^T
      // (one chunk after the other: their registers do not overlap) ---
#pragma unroll 1
      for (int sc = 0; sc < CPS; ++sc) {
        const int j0 = ((k - 4) * CPS + sc) * FC;
        const unsigned char* t = st + sc * Cv::kChunk;
        const bf16* w2c = reinterpret_cast<const bf16*>(t);
        const bf16* wa = reinterpret_cast<const bf16*>(t + Cv::kW2);
        const bf16* wb = reinterpret_cast<const bf16*>(t + Cv::kW2 +
                                                       Cv::kW13);
        float df[FC / 2], x1[FC / 2], x3[FC / 2];
        {
          uint32_t da[DW / 16][4], h2a[DW / 16][4];
          frags_of(dout, D, D, da);
          unkeep(h2_keep, reinterpret_cast<uint32_t(&)[DW / 4]>(h2a));
          sm90::wgmma_fence();
          chain<FC, 0>(df, da, [&](int kk) {
            return Tile<DW>::desc_k(w2c, FC, kk);
          }, false);
          chain<FC, 1>(x1, h2a, [&](int kk) {
            return Tile<FC>::desc_mn(wa, DW, kk);
          }, false);
          chain<FC, 1>(x3, h2a, [&](int kk) {
            return Tile<FC>::desc_mn(wb, DW, kk);
          }, false);
          finish(df);
          sm90::reg_fence(x1);
          sm90::reg_fence(x3);
        }
        bf16* fs = static_cast<bf16*>(p.fs) + row0 * F + j0;
        bf16* dx13 = static_cast<bf16*>(p.dx13s) + row0 * 2 * F + j0;
#pragma unroll
        for (int i = 0; i < FC / 2; i += 2) {
          const int r = acc_row(i), c = acc_col(i);
          float fv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sg = fast_sigmoid(x1[i + e]);
            const float sx = x1[i + e] * sg;
            const float kp =
                drop ? keep_factor(key2,
                                   (uint32_t)((t0 + r) * F + j0 + c + e),
                                   p.thr, p.keep_scale)
                     : 1.0f;
            const float dfv = df[i + e] * kp;
            fv[e] = sx * x3[i + e] * kp;
            x1[i + e] = dfv * x3[i + e] * (sg * (1.0f + x1[i + e] *
                                                            (1.0f - sg)));
            x3[i + e] = dfv * sx;
          }
          if (j0 + c < F) {
            *reinterpret_cast<__nv_bfloat162*>(fs + (size_t)r * F + c) =
                __floats2bfloat162_rn(fv[0], fv[1]);
            *reinterpret_cast<__nv_bfloat162*>(dx13 + (size_t)r * 2 * F +
                                               c) =
                __floats2bfloat162_rn(x1[i], x1[i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dx13 + (size_t)r * 2 * F +
                                               F + c) =
                __floats2bfloat162_rn(x3[i], x3[i + 1]);
          }
        }
        uint32_t d1a[FC / 16][4], d3a[FC / 16][4];
        frags(x1, d1a);
        frags(x3, d3a);
        sm90::wgmma_fence();
        chain<DW, 0>(dh2, d1a, [&](int kk) {
          return Tile<FC>::desc_k(wa, DW, kk);
        }, true);
        chain<DW, 0>(dh2, d3a, [&](int kk) {
          return Tile<FC>::desc_k(wb, DW, kk);
        }, true);
        finish(dh2);
      }

      if (k == spt - 1) {
        // --- LN3': dy = dout + LN3'(dh2); dg = T(dy) Wo^T; LN2' -> dav ---
        float xh[NF];
        unkeep(y_keep, xh);
#pragma unroll
        for (int i = 0; i < NF; ++i)
          xh[i] = acc_col(i) < D ? (xh[i] - mu3[(i >> 1) & 1]) *
                                       rs3[(i >> 1) & 1]
                                 : 0.0f;
        col_part<DW>(wsum + 8 * DW, [&](int i) { return dh2[i] * xh[i]; });
        col_part<DW>(wsum + 12 * DW, [&](int i) { return dh2[i]; });
        float m1[2], m2[2];
        row_means<NF>([&](int i) { return dh2[i] * g3[acc_col(i)]; },
                      [&](int i) { return xh[i]; }, D, m1, m2);
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const int hf = (i >> 1) & 1, c = acc_col(i);
          const float2 dv = ld_bf16x2(dout, D, i, D);
          const float2 gg = ld_vec2(g3, i, D);
          const bool in = c < D;
          dh2[i] = in ? dv.x + rs3[hf] * (dh2[i] * gg.x - m1[hf] -
                                          xh[i] * m2[hf])
                      : 0.0f;
          dh2[i + 1] = in ? dv.y + rs3[hf] * (dh2[i + 1] * gg.y - m1[hf] -
                                              xh[i + 1] * m2[hf])
                          : 0.0f;
        }
        st_f32(p.dy + row0 * D, D, dh2, D);
        st_bf16(static_cast<bf16*>(p.dys) + row0 * D, D, dh2, D);
        col_part<DW>(wsum + 16 * DW, [&](int i) { return dh2[i]; });
        uint32_t dya[DW / 16][4];
        frags(dh2, dya);
        float dg[NF];
        sm90::wgmma_fence();
        chain<DW, 0>(dg, dya, [&](int kk) {
          return Tile<DW>::desc_k(wo_s, DW, kk);
        }, false);
        finish(dg);
        float* du = p.du + row0 * D;
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const int hf = (i >> 1) & 1, r = acc_row(i), c = acc_col(i);
          const float2 e = ld_bf16x2(av, D, i, D);
          const float2 gg = ld_vec2(g2, i, D), bb = ld_vec2(b2, i, D);
          float k0 = 1.0f, k1 = 1.0f;
          if (drop) {
            const uint32_t cnt = (uint32_t)((t0 + r) * D + c);
            k0 = keep_factor(key1, cnt, p.thr, p.keep_scale);
            k1 = keep_factor(key1, cnt + 1u, p.thr, p.keep_scale);
          }
          const bool in = c < D;
          xh[i] = in ? (e.x - mu2[hf]) * rs2[hf] : 0.0f;
          xh[i + 1] = in ? (e.y - mu2[hf]) * rs2[hf] : 0.0f;
          const float d0 = dg[i] * k0, d1 = dg[i + 1] * k1;
          // du = dg LN2(av) out; dav_ln = dg u in dg's place
          if (in)
            *reinterpret_cast<float2*>(du + (size_t)r * D + c) = make_float2(
                d0 * (xh[i] * gg.x + bb.x), d1 * (xh[i + 1] * gg.y + bb.y));
          dg[i] = d0 * u_keep[i * kWg + tid];
          dg[i + 1] = d1 * u_keep[(i + 1) * kWg + tid];
        }
        col_part<DW>(wsum, [&](int i) { return dg[i] * xh[i]; });
        col_part<DW>(wsum + 4 * DW, [&](int i) { return dg[i]; });
        row_means<NF>([&](int i) { return dg[i] * g2[acc_col(i)]; },
                      [&](int i) { return xh[i]; }, D, m1, m2);
#pragma unroll
        for (int i = 0; i < NF; ++i) {
          const int hf = (i >> 1) & 1, c = acc_col(i);
          dg[i] = c < D ? rs2[hf] * (dg[i] * g2[c] - m1[hf] - xh[i] * m2[hf])
                        : 0.0f;
        }
        st_bf16(static_cast<bf16*>(p.dav) + row0 * D, D, dg, D);
        __syncthreads();
        fold_cols<DW>(sums, wsum, 5);
      }
    }
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  __syncthreads();
  // the block's LN2, LN3 and bias sums: ln rows 2-5, then bo
  float* part = p.part + (size_t)blockIdx.x * p.P;
  for (int i = tid; i < 5 * D; i += kWg) {
    const int k = i / D, c = i - k * D;
    part[(k < 4 ? p.off_ln + (2 + k) * D : p.off_bo) + c] = sums[k * DW + c];
  }
}

// One product over tokens: out[Mo x No] = A^T B, A [tokens, Mo] and B
// [tokens, No] bf16 (row strides Mo and No), written at ``off`` of a row of
// ``part`` (row-major, row stride No)
struct WgradJob {
  const void* a;
  const void* b;
  int mo, no, off, tiles_m, tiles_n;
};

constexpr int kWgradJobs = 4;   // the gate's three, the projection's one

struct WgradArgs {
  WgradJob job[kWgradJobs];
  int njob;
  float* part;
  int P;
  int ntok;   // token tiles of 64
  int per;    // token tiles of one range (one row of part)
};

constexpr size_t kWgradTile = sm90::Tile<64>::bytes(fb90::kRows);
constexpr size_t kWgradStage = 2 * kWgradTile;

__global__ void __launch_bounds__(fb90::kWg)
    wgrad_wgmma_kernel(WgradArgs p) {
  using namespace fb90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  int t = blockIdx.x, j = 0;
  while (j < p.njob - 1 && t >= p.job[j].tiles_m * p.job[j].tiles_n) {
    t -= p.job[j].tiles_m * p.job[j].tiles_n;
    ++j;
  }
  const WgradJob jb = p.job[j];
  const int m0 = (t / jb.tiles_n) * 64, n0 = (t % jb.tiles_n) * 64;
  const int first = blockIdx.y * p.per;
  const int n = min(p.ntok, first + p.per) - first;
  if (n <= 0) return;
  const int wa = min(64, jb.mo - m0), wb = min(64, jb.no - n0);
  const bf16* A = static_cast<const bf16*>(jb.a) + m0;
  const bf16* B = static_cast<const bf16*>(jb.b) + n0;
  auto issue = [&](int s) {
    if (s < n) {
      unsigned char* st = base + (s % sm90::kStages) * kWgradStage;
      const size_t tok = (size_t)(first + s) * kRows;
      load_mat<64>(reinterpret_cast<bf16*>(st), kRows, A + tok * jb.mo,
                   jb.mo, kRows, wa);
      load_mat<64>(reinterpret_cast<bf16*>(st + kWgradTile),
                   kRows, B + tok * jb.no, jb.no, kRows, wb);
    }
    sm90::cp_async_commit();
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  issue(0);
  for (int step = 0; step < n; ++step) {
    issue(step + 1);
    sm90::cp_async_wait<1>();
    sm90::fence_async_smem();
    __syncthreads();
    const unsigned char* st = base + (step % sm90::kStages) * kWgradStage;
    const bf16* sa = reinterpret_cast<const bf16*>(st);
    const bf16* sb = reinterpret_cast<const bf16*>(st + kWgradTile);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::mma_ss_n64<1, 1>(acc, Tile<64>::desc_mn(sa, kRows, kk),
                             Tile<64>::desc_mn(sb, kRows, kk), 1);
    finish(acc);
    __syncthreads();  // this stage is read; a later issue reloads it
  }
  float* out = p.part + (size_t)blockIdx.y * p.P + jb.off;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i), c = acc_col(i);
    if (r < wa && c < wb)
      *reinterpret_cast<float2*>(out + (size_t)(m0 + r) * jb.no + n0 + c) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// ===========================================================================
// proj_bwd_wgmma_kernel: the projection and LN1 backward, the bf16 instance
// on wgmma (csrc/fused_block_sm90.cuh)
// ===========================================================================
//
// The same function as proj_bwd_kernel, for bf16 at D <= 128 (padded to DW
// = 32, 64 or 128 columns): the whole-sequence and chunked backward's last
// step and the ring's stage 1. Persistent blocks of one warpgroup, as many
// as share an SM, stride over the 64-token tiles. Per tile, with register
// accumulators:
// - x's rows (8-byte loads), LN1 into T(h1)'s A fragments by the forward's
//   function (ln1); T(h1) written to the h1s scratch and kept in shared
//   memory for the four slices, each thread its own fragments;
// - per slice k of Wuvqk (u, v, q, k): pre = T(h1) W_k (RS wgmma, W_k an
//   MN-major B); its cotangent (du in f32; dv, dq, dk in f32, or in bf16 in
//   the ring's stage 1; 16- or 8-byte loads); duvqk = cotangent times 1,
//   1/L, dq_scale or 1, then times dsilu(pre + b_k), in f32 (the order of
//   _bwd_proj_kernel_chunk and the ring's _rpp_bwd); its column sums
//   (dbuvqk); T(duvqk) written to the duvqks scratch; dh1 += T(duvqk) W_k^T
//   (RS wgmma, the same W_k tile as a K-major B: no weight is transposed or
//   loaded twice);
// - the LN1 backward per row by quad shuffles, with its gamma and beta
//   column sums; dx = T(dy + LN1'(dh1)), dy null in the ring's stage 1.
// Its time goes to latency within each warp more than to occupancy: with
// the compiler's own register count (about 240 at DW = 64, two blocks an
// SM) it runs faster than capped for three or four blocks, which spills
// (PERF.md). Each tile's six column sums go, the four warps' shares added
// in a fixed order, to the tile's rows of the psum scratch, which
// reduce_rows_split_kernel sums in a fixed order after the kernel
// (finish_grads): the block count follows the card, not G (sums per block
// instead cost the kernel more than they save the sum). dWuvqk =
// T(h1)^T T(duvqk) is taken over token ranges from the scratch by
// wgrad_wgmma_kernel: a register accumulator of dWuvqk per block (at D=64
// a 64 x 256 f32 tile, 128 registers a thread) would not fit beside dh1 and
// the slice. Wuvqk stays in shared memory at DW <= 64; at DW = 128 its
// slices stream through the two-stage cp.async ring.
//
// Bound: memory. At the flagship (B=128, L=1024, D=64) x, the f32
// cotangents and dy in and dx out are 201 MB (60 us at 3.35 TB/s) against
// 12.9 GFLOP (13 us); the scratch adds 84 MB written and read again.
template <int DW>
struct ProjBwdCarve {
  static constexpr size_t kW = fb90::WuvqkSlices<DW>::kBytes;
  // T(h1)'s fragments, [element][thread]
  static constexpr size_t kKeep = (size_t)(DW / 4) * fb90::kWg * 4;
  // the warps' shares of the six column sums (dbuvqk's four slices, LN1's
  // gamma and beta) in two buffers, [2][6][4][DW]
  static constexpr size_t kRed = fb90::round1024((size_t)48 * DW * 4);
  static constexpr size_t bytes() { return 1024 + kW + kKeep + kRed; }
};

template <int DW>
__global__ void __launch_bounds__(fb90::kWg) proj_bwd_wgmma_kernel(BwdArgs p) {
  using namespace fb90;
  using Cv = ProjBwdCarve<DW>;
  constexpr int NF = DW / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const int D = p.D, tid = threadIdx.x;
  uint32_t* h1_keep = reinterpret_cast<uint32_t*>(base + Cv::kW);
  float* wsum = reinterpret_cast<float*>(base + Cv::kW + Cv::kKeep);
  const int ntiles = p.B * (p.L / kRows);
  const int mine = (int)blockIdx.x < ntiles
                       ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const WuvqkSlices<DW> ws{base, static_cast<const bf16*>(p.wuvqk), D,
                           4 * mine};
  ws.start();
  // cotangent k of the tile at row0 (k == 4: the residual dy, 0 if null)
  auto load_cot = [&](size_t row0, int k, float (&g)[NF]) {
    if (k == 0 || k == 4) {
      const float* c = k == 0 ? p.du : p.dy;
      if (c) {
        ld_f32_q(c + row0 * D, D, D, g);
      } else {
#pragma unroll
        for (int i = 0; i < NF; ++i) g[i] = 0.0f;
      }
      return;
    }
    const float* c = k == 1 ? p.dv : k == 2 ? p.dq : p.dk;
    if (p.cot_t)
      ld_bf16_q(reinterpret_cast<const bf16*>(c) + row0 * D, D, D, g);
    else
      ld_f32_q(c + row0 * D, D, D, g);
  };

  for (int ti = 0; ti < mine; ++ti) {
    const int tile = blockIdx.x + ti * gridDim.x;
    const size_t row0 = (size_t)tile * kRows;
    const bf16* x = static_cast<const bf16*>(p.x) + row0 * D;
    float* wbuf = wsum + (ti & 1) * 24 * DW;
    float mu[2], rs[2];
    {
      uint32_t xr[NF / 2], h1a[DW / 16][4];
      ld_pairs(x, D, D, xr);
      ln1<DW>(xr, p.ln, D, h1a, mu, rs);
      keep(h1_keep, reinterpret_cast<uint32_t(&)[DW / 4]>(h1a));
      st_pairs(static_cast<bf16*>(p.h1s) + row0 * D, D, D,
               reinterpret_cast<const uint32_t(&)[NF / 2]>(h1a));
    }

    float dh1[NF];
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const bf16* w = ws.acquire(4 * ti + k);
      float pre[NF];
      {
        uint32_t h1a[DW / 16][4];
        unkeep(h1_keep, reinterpret_cast<uint32_t(&)[DW / 4]>(h1a));
        proj_slice<DW>(pre, h1a, w);
      }
      // --- duvqk = cotangent * mul * dsilu(pre + b_k), f32 ---
      {
        float g[NF];
        load_cot(row0, k, g);
        const float mul = k == 1 ? p.inv_len : k == 2 ? p.dq_scale : 1.0f;
        const float* bk = p.buvqk + k * D;
#pragma unroll
        for (int i = 0; i < NF; i += 2) {
          const float2 bb = ld_vec2(bk, i, D);
          const bool in = acc_col(i) < D;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = pre[i + e] + (e ? bb.y : bb.x);
            const float sg = fast_sigmoid(v);
            pre[i + e] = in ? g[i + e] * mul *
                                  (sg * (1.0f + v * (1.0f - sg)))
                            : 0.0f;
          }
        }
      }
      st_bf16_q(static_cast<bf16*>(p.duvqks) + row0 * 4 * D + k * D, 4 * D,
                D, pre);
      col_part<DW>(wbuf + k * 4 * DW, [&](int i) { return pre[i]; });
      // --- dh1 += T(duvqk) W_k^T ---
      uint32_t da[DW / 16][4];
      frags(pre, da);
      sm90::wgmma_fence();
      chain<DW, 0>(dh1, da, [&](int kk) {
        return Tile<DW>::desc_k(w, DW, kk);
      }, k > 0);
      finish(dh1);
      ws.release();
    }

    // --- LN1 backward: gamma/beta sums, then dx = T(dy + LN1'(dh1)) ---
    float xh[NF];
    {
      uint32_t xr[NF / 2];
      ld_pairs(x, D, D, xr);   // again: the tile is still in L2
#pragma unroll
      for (int q = 0; q < NF / 2; ++q) {
        const float2 e = unpack_bf16(xr[q]);
        xh[2 * q] = e.x;
        xh[2 * q + 1] = e.y;
      }
    }
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int hf = (i >> 1) & 1;
      xh[i] = acc_col(i) < D ? (xh[i] - mu[hf]) * rs[hf] : 0.0f;
    }
    col_part<DW>(wbuf + 16 * DW, [&](int i) { return dh1[i] * xh[i]; });
    col_part<DW>(wbuf + 20 * DW, [&](int i) { return dh1[i]; });
    float m1[2], m2[2];
    row_means<NF>([&](int i) { return dh1[i] * p.ln[acc_col(i)]; },
                  [&](int i) { return xh[i]; }, D, m1, m2);
    {
      float dy[NF];
      load_cot(row0, 4, dy);
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int hf = (i >> 1) & 1, c = acc_col(i);
        dh1[i] = c < D ? dy[i] + rs[hf] * (dh1[i] * p.ln[c] - m1[hf] -
                                           xh[i] * m2[hf])
                       : 0.0f;
      }
    }
    st_bf16_q(static_cast<bf16*>(p.dx) + row0 * D, D, D, dh1);
    __syncthreads();
    // the tile's column sums, the warps' shares in order: dbuvqk to its row
    // of psum's first [ntiles, 4D], LN1's gamma and beta to the second's
    // [ntiles, 2D]
    for (int i = tid; i < 6 * D; i += kWg) {
      const int k = i / D, c = i - k * D;
      const float* wk = wbuf + k * 4 * DW;
      p.psum[k < 4 ? (size_t)tile * 4 * D + i
                   : (size_t)ntiles * 4 * D + (size_t)tile * 2 * D + i -
                         4 * D] =
          ((wk[c] + wk[DW + c]) + wk[2 * DW + c]) + wk[3 * DW + c];
    }
  }
}

// Whether the wgmma gate/FFN kernels can take these operands: bf16, D at
// most 128, the whole scratch there, every operand they stream with
// cp.async on a 16-byte boundary. The wrapper passes the scratch exactly
// where it wants them (ops/fused_block.block_wgmma); with the scratch there,
// a launch they cannot make fails rather than taking the other instance.
inline bool gate_wgmma_ok(const BwdArgs& p, bool is_bf16) {
  return is_bf16 && fb90::post_width(p.D) != 0 && p.fs && p.dx13s &&
         p.h2s && p.gs && p.dys && sm90::aligned16(p.fs) &&
         sm90::aligned16(p.dx13s) && sm90::aligned16(p.h2s) &&
         sm90::aligned16(p.gs) && sm90::aligned16(p.dys) &&
         sm90::aligned16(p.dout) && sm90::aligned16(p.wuvqk) &&
         sm90::aligned16(p.wo) && sm90::aligned16(p.w13) &&
         sm90::aligned16(p.w2);
}

// The wgmma instances run exactly where their scratch is there (the
// wrapper passes it in bf16 at D <= 128: ops/fused_block.block_wgmma): the
// gate/FFN backward's, and the projection backward's.
inline bool gate_wgmma_on(const BwdArgs& p) { return p.fs != nullptr; }
inline bool proj_wgmma_on(const BwdArgs& p) { return p.h1s != nullptr; }

// Whether proj_bwd_wgmma_kernel can take these operands: bf16, D at most
// 128, its scratch there, every operand of its 8- and 16-byte accesses and
// cp.async on a 16-byte boundary.
inline bool proj_wgmma_ok(const BwdArgs& p, bool is_bf16) {
  return is_bf16 && fb90::post_width(p.D) != 0 && p.h1s && p.duvqks &&
         p.psum && sm90::aligned16(p.h1s) && sm90::aligned16(p.duvqks) &&
         sm90::aligned16(p.x) && sm90::aligned16(p.wuvqk) &&
         sm90::aligned16(p.dx) && sm90::aligned16(p.du) &&
         sm90::aligned16(p.dv) && sm90::aligned16(p.dq) &&
         sm90::aligned16(p.dk) && sm90::aligned16(p.dy);
}

// The weight products over tokens of the wgmma instances that ran (dW2,
// dW13 and dWo of the gate; dWuvqk of the projection), over ranges of at
// least 16 token tiles, at most G ranges (rows of part; the rows past the
// last range stay 0)
inline int launch_wgrad(const BwdArgs& p, cudaStream_t stream) {
  WgradArgs w = {};
  auto job = [](const void* a, int mo, const void* b, int no, int off) {
    WgradJob j;
    j.a = a;
    j.b = b;
    j.mo = mo;
    j.no = no;
    j.off = off;
    j.tiles_m = (mo + 63) / 64;
    j.tiles_n = (no + 63) / 64;
    return j;
  };
  if (gate_wgmma_on(p)) {
    w.job[w.njob++] = job(p.fs, p.F, p.dout, p.D, p.off_w2);
    w.job[w.njob++] = job(p.h2s, p.D, p.dx13s, 2 * p.F, p.off_w13);
    w.job[w.njob++] = job(p.gs, p.D, p.dys, p.D, p.off_wo);
  }
  if (proj_wgmma_on(p))
    w.job[w.njob++] = job(p.h1s, p.D, p.duvqks, 4 * p.D, p.off_wuvqk);
  if (w.njob == 0) return 0;
  w.part = p.part;
  w.P = p.P;
  w.ntok = p.B * p.L / fb90::kRows;
  w.per = max(16, (w.ntok + p.G - 1) / p.G);
  const int ranges = (w.ntok + w.per - 1) / w.per;
  int tiles = 0;
  for (int j = 0; j < w.njob; ++j) tiles += w.job[j].tiles_m * w.job[j].tiles_n;
  return hstu_bwd::launch_kernel(wgrad_wgmma_kernel, dim3(tiles, ranges),
                                 fb90::kWg, 1024 + sm90::kStages * kWgradStage,
                                 stream, w);
}

template <typename T>
int pick_tile(int L, size_t (*smem)(int, int), int D) {
  for (int t = 64; t >= 16; t >>= 1)
    if (L % t == 0 && smem(D, t) <= kMaxSmem) return t;
  return 0;
}

// Step 1, the gate/FFN backward: gate_ffn_bwd_wgmma_kernel where its
// scratch is there (its weight products follow in launch_wgrad), else
// gate_ffn_bwd_kernel (WMMA through shared memory in bf16, FMA loops in
// f32).
template <typename T>
int launch_gate(const BwdArgs& p, bool tc, cudaStream_t stream) {
  if (gate_wgmma_on(p)) {
    if (!gate_wgmma_ok(p, std::is_same<T, bf16>::value))
      return (int)cudaErrorInvalidValue;
    switch (fb90::post_width(p.D)) {
      case 32:
        return hstu_bwd::launch_kernel(gate_ffn_bwd_wgmma_kernel<32>,
                                       dim3(p.G), fb90::kWg,
                                       GateCarve<32>::bytes(), stream, p);
      case 64:
        return hstu_bwd::launch_kernel(gate_ffn_bwd_wgmma_kernel<64>,
                                       dim3(p.G), fb90::kWg,
                                       GateCarve<64>::bytes(), stream, p);
      default:
        return hstu_bwd::launch_kernel(gate_ffn_bwd_wgmma_kernel<128>,
                                       dim3(p.G), fb90::kWg,
                                       GateCarve<128>::bytes(), stream, p);
    }
  }
  const int TM = pick_tile<T>(p.L, gate_smem<T>, p.D);
  if (TM == 0) return (int)cudaErrorInvalidValue;
  return hstu_bwd::launch_kernel(gate_ffn_bwd_kernel<T>, dim3(p.G), kThreads,
                                 gate_smem<T>(p.D, TM), stream, p, TM, tc);
}

// Step 3, the projection and LN1 backward: proj_bwd_wgmma_kernel where its
// scratch is there (dWuvqk follows in launch_wgrad; *rows its tile count,
// the rows of psum), else proj_bwd_kernel (*rows 0).
template <typename T>
int launch_proj_bwd(const BwdArgs& p, bool tc, cudaStream_t stream,
                    int* rows) {
  *rows = 0;
  if (proj_wgmma_on(p)) {
    if (!proj_wgmma_ok(p, std::is_same<T, bf16>::value))
      return (int)cudaErrorInvalidValue;
    const int ntiles = p.B * (p.L / fb90::kRows);
    *rows = ntiles;
    switch (fb90::post_width(p.D)) {
      case 32:
        return fb90::launch_persistent(proj_bwd_wgmma_kernel<32>,
                                       ProjBwdCarve<32>::bytes(), ntiles,
                                       stream, p);
      case 64:
        return fb90::launch_persistent(proj_bwd_wgmma_kernel<64>,
                                       ProjBwdCarve<64>::bytes(), ntiles,
                                       stream, p);
      default:
        return fb90::launch_persistent(proj_bwd_wgmma_kernel<128>,
                                       ProjBwdCarve<128>::bytes(), ntiles,
                                       stream, p);
    }
  }
  const int TM = pick_tile<T>(p.L, gate_smem<T>, p.D);
  if (TM == 0) return (int)cudaErrorInvalidValue;
  return hstu_bwd::launch_kernel(proj_bwd_kernel<T>, dim3(p.G), kThreads,
                                 proj_bwd_smem<T>(p.D, TM), stream, p, TM,
                                 tc);
}

// The weight products over tokens, then the fixed-order sums of part's
// rows and, after proj_bwd_wgmma_kernel (proj_rows: psum's rows, one a
// tile; 0: the kernel did not run), of psum's rows into dbuvqk's and LN1's
// slots of grads (which part's rows leave 0).
inline int finish_grads(const BwdArgs& p, int proj_rows,
                        cudaStream_t stream) {
  int e = launch_wgrad(p, stream);
  if (e != 0) return e;
  reduce_rows_kernel<<<(p.P + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(p.part, p.G, p.P, p.grads);
  if ((e = (int)cudaGetLastError()) != 0 || proj_rows == 0) return e;
  const int ntiles = p.B * (p.L / fb90::kRows);
  const dim3 block(32, kSplitRows);
  reduce_rows_split_kernel<<<(4 * p.D + 31) / 32, block, 0, stream>>>(
      p.psum, proj_rows, 4 * p.D, p.grads + p.off_buvqk);
  reduce_rows_split_kernel<<<(2 * p.D + 31) / 32, block, 0, stream>>>(
      p.psum + (size_t)ntiles * 4 * p.D, proj_rows, 2 * p.D,
      p.grads + p.off_ln);
  return (int)cudaGetLastError();
}

// The attention backward's arguments: the pair of shards at off 0, Lq = Lk
// = L, dq times hd^-1/2.
hstu_bwd::AttnBwdArgs attn_args(const BwdArgs& p) {
  hstu_bwd::AttnBwdArgs a = {};
  a.q = p.q;
  a.k = p.k;
  a.v = p.v;
  a.dav = p.dav;
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
  return a;
}

// Which instance runs where: with their scratch (the wrapper passes it in
// bf16 at D <= 128, every fused preset) gate_ffn_bwd_wgmma_kernel and
// proj_bwd_wgmma_kernel, their weight products in one wgrad_wgmma_kernel
// launch; without it (f32, the tight check instance, and D > 128)
// gate_ffn_bwd_kernel and proj_bwd_kernel (WMMA through shared memory in
// bf16, FMA loops in f32). The attention backward chooses its own
// (hstu_bwd::launch).
template <typename T>
int launch_bwd(const BwdArgs& p, bool tc, cudaStream_t stream) {
  int e = launch_gate<T>(p, tc, stream);
  if (e != 0) return e;
  // dq and the rel-pos gradient (summed into drab), then dk and dv
  e = hstu_bwd::launch<T>(attn_args(p), true, true, stream);
  if (e != 0) return e;
  int rows = 0;
  e = launch_proj_bwd<T>(p, tc, stream, &rows);
  return e != 0 ? e : finish_grads(p, rows, stream);
}

// One stage of a sequence-sharded ring's backward, on a shard of L tokens:
// stage 0 runs the gate/FFN backward alone (replacing
// _bwd_gate_kernel_chunk, l.612, as ring_post_gate's backward launches it:
// dav in T, dy and du in f32, the gradients of W2, W13, Wo, bo and
// LN2/LN3), stage 1 the projection backward alone (replacing
// _bwd_proj_kernel_chunk, l.710, as ring_pre_proj's backward launches it:
// no residual, dy null, as the post stage owns the residual path; dq, dk,
// dv in T as the pairs' backward returns them, dq times dq_scale = hd^-1/2
// in f32, dv w.r.t. the 1/L-scaled v, inv_len 1 / the whole sequence's
// length), each as launch_bwd chooses its instance; each then takes its
// weight products and sums its partials. The other stage's gradient slots
// of ``grads`` come out 0.
template <typename T>
int launch_stage(const BwdArgs& p, int stage, bool tc, cudaStream_t stream) {
  int rows = 0;
  const int e = stage == 0 ? launch_gate<T>(p, tc, stream)
                           : launch_proj_bwd<T>(p, tc, stream, &rows);
  return e != 0 ? e : finish_grads(p, rows, stream);
}

}  // namespace

// Plain C entry point of one ring stage (launch_stage above): stage 0 or 1,
// ``args`` as for fused_block_bwd (the fields the stage does not read may be
// null). Returns a cudaError_t code (0 on success).
extern "C" int fused_block_bwd_stage(int is_bf16, const BwdArgs* args,
                                     int stage, void* stream) {
  const BwdArgs& p = *args;
  if (p.L % 64 != 0 || p.D % 16 != 0 || p.F % 16 != 0 || p.H <= 0 ||
      p.D % p.H != 0 || p.G <= 0 || p.D > kThreads || (stage != 0 &&
                                                        stage != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_stage<bf16>(p, stage, true, s);
  return launch_stage<float>(p, stage, false, s);
}

// Plain C entry point (bound with ctypes): ``args`` points to a BwdArgs
// (the wrapper mirrors the struct field for field). Requires L % 64 == 0,
// D % 16 == 0, F % 16 == 0, D % H == 0 and the pointers of BwdArgs' comments.
// Returns a cudaError_t code (0 on success).
extern "C" int fused_block_bwd(int is_bf16, const BwdArgs* args,
                               void* stream) {
  const BwdArgs& p = *args;
  if (p.L % 64 != 0 || p.D % 16 != 0 || p.F % 16 != 0 || p.H <= 0 ||
      p.D % p.H != 0 || p.NB <= 0 || p.G <= 0 || p.D > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_bwd<bf16>(p, true, s);
  return launch_bwd<float>(p, false, s);
}
