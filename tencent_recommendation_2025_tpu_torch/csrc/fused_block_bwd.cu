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
// Bound on the H100 at the flagship shape (B=128, L=1024, D=64, F=256,
// H=1), per block: 93.46 GFLOP of products (recompute: projection 4.29,
// s 8.60, Wo 1.07, W13 8.59; attention dv, da, dq, dk 8.60 each; weight
// products twice each, dW and dX: projection 8.59, Wo 2.15, W13 17.18, W2
// 8.59), 94.5 us at 989 TFLOP/s bf16, against 67 MB of x, av, dout and dx
// (20 us at 3.35 TB/s): compute bound. gate_ffn_bwd and proj_bwd run their
// products as WMMA tiles (bf16, f32 accumulators) through shared memory.

#include "fused_block_common.cuh"
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
  float* dy;           // [B, L, D]
  float* dv;           // [B, L, D], w.r.t. the scaled v
  float* dq;           // [B, L, D], times hd^-1/2
  float* dk;           // [B, L, D]
  float* part;         // [G, P] zeroed: per-block partial sums
  float* part_rab;     // [B * L / 16, H * NB]: per-(query tile, row) partials
  // outputs
  void* dx;            // [B, L, D] T
  float* grads;        // [P]: dW2, dW13, dWo, dbo, dln, dWuvqk, dbuvqk
  float* drab;         // [H, NB]
  int B, L, D, H, F, NB;
  int G, P;            // blocks of the striding kernels; partial row width
  int off_w2, off_w13, off_wo, off_bo, off_ln, off_wuvqk, off_buvqk;
  float scale, inv_len;
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

// Step 3: the projection and LN1 backward plus the residual, per TM-token
// tile: duvqk = [du, dv / L, dq, dk] dsilu(pre), dWuvqk, dbuvqk, dx.
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
        const float src = part_i == 0   ? p.du[o]
                          : part_i == 1 ? p.dv[o] * p.inv_len
                          : part_i == 2 ? p.dq[o]
                                        : p.dk[o];
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
        static_cast<T*>(p.dx)[o] =
            from_f<T>(p.dy[o] + rsr * (g[d] * g1[d] - m1 - xh * m2));
      }
    }
  }
}

template <typename T>
int pick_tile(int L, size_t (*smem)(int, int), int D) {
  for (int t = 64; t >= 16; t >>= 1)
    if (L % t == 0 && smem(D, t) <= kMaxSmem) return t;
  return 0;
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

template <typename T>
int launch_bwd(const BwdArgs& p, bool tc, cudaStream_t stream) {
  const int TM = pick_tile<T>(p.L, gate_smem<T>, p.D);
  if (TM == 0) return (int)cudaErrorInvalidValue;
  const size_t sm_g = gate_smem<T>(p.D, TM);
  const size_t sm_p = proj_bwd_smem<T>(p.D, TM);
  cudaError_t e;
  e = cudaFuncSetAttribute(gate_ffn_bwd_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm_g);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(proj_bwd_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm_p);
  if (e != cudaSuccess) return (int)e;

  gate_ffn_bwd_kernel<T><<<p.G, kThreads, sm_g, stream>>>(p, TM, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dq and the rel-pos gradient (summed into drab), then dk and dv
  const int ea = hstu_bwd::launch<T>(attn_args(p), true, true, stream);
  if (ea != 0) return ea;
  proj_bwd_kernel<T><<<p.G, kThreads, sm_p, stream>>>(p, TM, tc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_rows_kernel<<<(p.P + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(p.part, p.G, p.P, p.grads);
  return (int)cudaGetLastError();
}

// One stage of a sequence-sharded ring's backward, on a shard of L tokens:
// stage 0 runs gate_ffn_bwd_kernel alone (replacing _bwd_gate_kernel_chunk,
// l.612, as ring_post_gate's backward launches it: dav in T, dy and du in
// f32, the gradients of W2, W13, Wo, bo and LN2/LN3), stage 1
// proj_bwd_kernel alone (replacing _bwd_proj_kernel_chunk, l.710, as
// ring_pre_proj's backward launches it, with dy zero: the post stage owns
// the residual path; dq comes in already scaled by hd^-1/2, dv w.r.t. the
// 1/L-scaled v, inv_len 1 / the whole sequence's length); each then sums
// its partials with reduce_rows_kernel. The other stage's gradient slots of
// ``grads`` come out 0.
template <typename T>
int launch_stage(const BwdArgs& p, int stage, bool tc, cudaStream_t stream) {
  const int TM = pick_tile<T>(p.L, gate_smem<T>, p.D);
  if (TM == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (stage == 0) {
    const size_t sm = gate_smem<T>(p.D, TM);
    e = cudaFuncSetAttribute(gate_ffn_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    gate_ffn_bwd_kernel<T><<<p.G, kThreads, sm, stream>>>(p, TM, tc);
  } else {
    const size_t sm = proj_bwd_smem<T>(p.D, TM);
    e = cudaFuncSetAttribute(proj_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    proj_bwd_kernel<T><<<p.G, kThreads, sm, stream>>>(p, TM, tc);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_rows_kernel<<<(p.P + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(p.part, p.G, p.P, p.grads);
  return (int)cudaGetLastError();
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
