// HSTU attention of one (query shard, key shard) pair of a sequence-sharded
// ring, for Hopper, sm_90a: forward, dq and dk/dv.
//
// Replaces tencent_recommendation_2025_tpu/ops/fused_block.py::
// _pair_attn_fwd_kernel (l.1269), _pair_dq_kernel (l.1304) and
// _pair_dkdv_kernel (l.1345), which ring_pair_attn (l.1401) launches once per
// ring step. The query shard holds Lq tokens, the key shard Lk, and ``off``
// is the query shard's first global position minus the key shard's (in
// tokens, possibly negative), so a pair (r, c) sits at the global distance
// r + off - c. With q [B, Lq, D] (scaled by hd^-1/2), k and v [B, Lk, D] (v
// scaled by 1/L of the whole sequence), all in the compute dtype T (bf16 on
// the product path, f32 in the checks), per head h:
//
//   s  = q_h k_h^T + rab[h, min(dist, NB - 1)]               f32
//   a  = T(silu(s)) where dist >= 0 and the key is valid, else 0
//   av_h = a v_h                                              f32 partial
//
//   backward, with dot_b = T(dav): da = dot_b v_h^T; ds = da dsilu(s) on the
//   same pairs; dq = T(ds) k_h (w.r.t. the scaled q: no hd^-1/2, the
//   projection's backward applies it); dv = a^T dot_b; dk = T(ds)^T q_h;
//   drab[h, min(dist, NB - 1)] += ds, summed over the batch.
//
// Every output is f32: the ring sums the partials of its S steps in f32 and
// rounds once. The rounding points are the TPU kernels' (a and ds rounded to
// T as product operands), so the plain versions (ops/fused_block.
// ring_pair_fwd_plain and friends) agree to summation order. The TPU masks
// padded keys and the causal diagonal with an additive -1e4, whose silu and
// dsilu are exactly 0 in f32: the multiplicative mask here is the same
// function. Padded queries are not masked, as there.
//
// Design. The TPU grid (B, query blocks, key blocks) carries an accumulator
// across key blocks; here one block per (query tile, batch row) walks the key
// tiles itself (forward, dq), or one per (key tile, batch row) walks the
// query tiles (dk/dv), as csrc/fused_block.cu's attention loop and
// csrc/fused_block_bwd.cu's attn_dq / attn_dkdv do, with the offset added to
// every distance. Tiles whose pairs all lie in the future are skipped; the
// causal mask applies per element only where a distance is negative. The
// rel-pos gradient sums per diagonal of each tile into a per-(query tile,
// row) partial, which reduce_rows_kernel sums in a fixed order: no atomics,
// so the result is deterministic.
//
// Bound on the H100 per pair of shards of Lc tokens at D = 64, B = 32:
// forward 2 B D Lc^2 (causal pair: half of that) products, f32 partial out;
// at Lc = 2048 a full pair is 17.2 GFLOP, 17 us at 989 TFLOP/s bf16, against
// 33.6 MB of q, k, v and the f32 partial (10 us at 3.35 TB/s): compute bound,
// as is the backward (four products of that size). The products run as WMMA
// 16x16x16 bf16 tiles with f32 accumulators where hd % 16 == 0, as FMA loops
// otherwise (and in the f32 check instance).

#include "fused_block_common.cuh"

using namespace fbk;

// The pair kernels' arguments; the wrapper (ops/fused_block._PairArgs)
// mirrors this struct field for field.
struct PairArgs {
  const void* q;     // [B, Lq, D] T, scaled by hd^-1/2
  const void* k;     // [B, Lk, D] T
  const void* v;     // [B, Lk, D] T, scaled by 1/L
  const int* valid;  // [B, Lk] nonzero = valid key
  const float* rab;  // [H, NB]
  const void* dav;   // [B, Lq, D] T: the partial's cotangent (backward)
  float* av;         // [B, Lq, D] forward partial
  float* dq;         // [B, Lq, D], w.r.t. the scaled q
  float* dk;         // [B, Lk, D]
  float* dv;         // [B, Lk, D], w.r.t. the scaled v
  float* part_rab;   // [B * Lq / 16, H * NB] per-(query tile, row) partials
  float* drab;       // [H, NB]
  int B, Lq, Lk, D, H, NB;
  int off;           // first query position minus first key position
};

namespace {

template <typename T>
size_t fwd_smem(int D, int TT) {
  const size_t tile = align128((size_t)TT * (D + 8) * sizeof(T));
  return 3 * tile                                         // q, k, v
         + align128((size_t)TT * kLdS * sizeof(float))    // s
         + align128((size_t)TT * kLdP * sizeof(T))        // T(a)
         + align128((size_t)TT * (D + 4) * sizeof(float)) // av
         + align128(TT * sizeof(int));                    // key valid
}

template <typename T>
size_t bwd_smem(int D, int TT, int HNB) {
  const size_t tile = align128((size_t)TT * (D + 8) * sizeof(T));
  return 4 * tile                                            // q, k, v, dot_b
         + 2 * align128((size_t)TT * kLdS * sizeof(float))   // s, da / ds
         + 2 * align128((size_t)TT * kLdP * sizeof(T))       // T(a), T(ds)
         + 2 * align128((size_t)TT * (D + 4) * sizeof(float))  // accumulators
         + align128(TT * sizeof(int))                        // key valid
         + align128(HNB * sizeof(float))                     // rel-pos grads
         + align128(2 * TT * sizeof(float));                 // diagonal sums
}

// Forward: one query tile walks the key tiles that hold a pair at distance
// >= 0 (key position <= last query position + off).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_fwd_kernel(PairArgs p, int TT, bool tc) {
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
  float* ss = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * kLdS * sizeof(float));
  T* ps = reinterpret_cast<T*>(ptr);
  ptr += align128((size_t)TT * kLdP * sizeof(T));
  float* av = reinterpret_cast<float*>(ptr);
  ptr += align128((size_t)TT * ldf * sizeof(float));
  int* kval = reinterpret_cast<int*>(ptr);

  load_tile<T>(static_cast<const T*>(p.q) + ((size_t)b * p.Lq + q0) * D, TT,
               D, qs, ldt);
  for (int i = threadIdx.x; i < TT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    av[r * ldf + d] = 0.0f;
  }
  const int last = q0 + TT - 1 + p.off;  // the farthest key any query sees
  const size_t rowk = (size_t)b * p.Lk;
  for (int k0 = 0; k0 < p.Lk && k0 <= last; k0 += TT) {
    __syncthreads();  // the previous tile's products are done with ks/vs/ps
    load_tile<T>(static_cast<const T*>(p.k) + (rowk + k0) * D, TT, D, ks,
                 ldt);
    load_tile<T>(static_cast<const T*>(p.v) + (rowk + k0) * D, TT, D, vs,
                 ldt);
    for (int j = threadIdx.x; j < TT; j += kThreads)
      kval[j] = p.valid[rowk + k0 + j];
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      gemm<T, false, true, false>(qs + h * hd, ldt, ks + h * hd, ldt, ss,
                                  kLdS, TT, TT, hd, tc_attn);
      __syncthreads();
      const float* rab = p.rab + (size_t)h * NB;
      for (int i = threadIdx.x; i < TT * TT; i += kThreads) {
        const int r = i / TT, c = i - r * TT;
        const int dist = (q0 + r + p.off) - (k0 + c);
        float a = 0.0f;
        if (dist >= 0 && kval[c] != 0)
          a = silu(ss[r * kLdS + c] + rab[min(dist, NB - 1)]);
        ps[r * kLdP + c] = from_f<T>(a);
      }
      __syncthreads();
      gemm<T, false, false, true>(ps, kLdP, vs + h * hd, ldt, av + h * hd,
                                  ldf, TT, hd, TT, tc_attn);
      __syncthreads();
    }
  }
  __syncthreads();
  float* out = p.av + ((size_t)b * p.Lq + q0) * D;
  for (int i = threadIdx.x; i < TT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    out[i] = av[r * ldf + d];
  }
}

// dq and the rel-pos gradient: one query tile walks the key tiles as the
// forward does; the rel-pos sums of its pairs, per diagonal of each tile,
// go to its own row of part_rab.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_dq_kernel(PairArgs p, int TT, bool tc) {
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
               dsilu(ss[r * kLdS + c] + rab[min(dist, NB - 1)]);
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
    p.dq[(rowq + r) * D + d] = dq[r * ldf + d];
  }
  float* out = p.part_rab + ((size_t)b * gridDim.x + qt) * H * NB;
  for (int i = threadIdx.x; i < H * NB; i += kThreads) out[i] = drab[i];
}

// dk and dv: one key tile walks the query tiles that hold a pair at
// distance >= 0 with it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_dkdv_kernel(PairArgs p, int TT, bool tc) {
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
          a = silu(s);
          ds = das[r * kLdS + c] * dsilu(s);
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
    p.dk[(rowk + r) * D + d] = dk[r * ldf + d];
    p.dv[(rowk + r) * D + d] = dv[r * ldf + d];
  }
}

// Widest tile (64, 32 or 16 rows) dividing both lengths whose shared memory
// fits; 0 if none.
template <typename T>
int pick_tile(const PairArgs& p, bool bwd) {
  for (int t = 64; t >= 16; t >>= 1) {
    const size_t sm = bwd ? bwd_smem<T>(p.D, t, p.H * p.NB) : fwd_smem<T>(p.D, t);
    if (p.Lq % t == 0 && p.Lk % t == 0 && sm <= kMaxSmem) return t;
  }
  return 0;
}

template <typename T>
int launch(const PairArgs& p, int which, bool tc, cudaStream_t stream) {
  const int TT = pick_tile<T>(p, which != 0);
  if (TT == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (which == 0) {
    const size_t sm = fwd_smem<T>(p.D, TT);
    e = cudaFuncSetAttribute(pair_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    pair_fwd_kernel<T><<<dim3(p.Lq / TT, p.B), kThreads, sm, stream>>>(p, TT,
                                                                      tc);
    return (int)cudaGetLastError();
  }
  const size_t sm = bwd_smem<T>(p.D, TT, p.H * p.NB);
  if (which == 1) {
    e = cudaFuncSetAttribute(pair_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm);
    if (e != cudaSuccess) return (int)e;
    pair_dq_kernel<T><<<dim3(p.Lq / TT, p.B), kThreads, sm, stream>>>(p, TT,
                                                                     tc);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int hnb = p.H * p.NB;
    reduce_rows_kernel<<<(hnb + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(p.part_rab, p.B * (p.Lq / TT), hnb,
                                   p.drab);
    return (int)cudaGetLastError();
  }
  e = cudaFuncSetAttribute(pair_dkdv_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sm);
  if (e != cudaSuccess) return (int)e;
  pair_dkdv_kernel<T><<<dim3(p.Lk / TT, p.B), kThreads, sm, stream>>>(p, TT,
                                                                     tc);
  return (int)cudaGetLastError();
}

int dispatch(int is_bf16, const PairArgs* args, int which, void* stream) {
  const PairArgs& p = *args;
  if (p.Lq % 16 != 0 || p.Lk % 16 != 0 || p.D % 16 != 0 || p.H <= 0 ||
      p.D % p.H != 0 || p.NB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(p, which, true, s);
  return launch<float>(p, which, false, s);
}

}  // namespace

// Plain C entry points (bound with ctypes): ``args`` points to a PairArgs
// (the wrapper mirrors the struct field for field). ring_pair_fwd writes av;
// ring_pair_dq writes dq and drab (through part_rab, B * Lq / 16 rows);
// ring_pair_dkdv writes dk and dv. Requires Lq, Lk, D multiples of 16 and
// D % H == 0. Each returns a cudaError_t code (0 on success).
extern "C" int ring_pair_fwd(int is_bf16, const PairArgs* args,
                             void* stream) {
  return dispatch(is_bf16, args, 0, stream);
}

extern "C" int ring_pair_dq(int is_bf16, const PairArgs* args, void* stream) {
  return dispatch(is_bf16, args, 1, stream);
}

extern "C" int ring_pair_dkdv(int is_bf16, const PairArgs* args,
                              void* stream) {
  return dispatch(is_bf16, args, 2, stream);
}
