// HSTU attention of one (query shard, key shard) pair of a sequence-sharded
// ring, for Hopper, sm_90a: forward, dq and dk/dv.
//
// Replaces tencent_recommendation_2025_tpu/ops/fused_block.py::
// _pair_attn_fwd_kernel (l.1269) here, and _pair_dq_kernel (l.1304) and
// _pair_dkdv_kernel (l.1345) through csrc/hstu_attn_bwd_sm90.cuh; the JAX
// package's ring_pair_attn (l.1401) launches them once per ring step. The
// query shard holds Lq tokens, the key shard Lk, and ``off`` is the query
// shard's first global position minus the key shard's (in tokens, possibly
// negative), so a pair (r, c) sits at the global distance r + off - c. With
// q [B, Lq, D] (scaled by hd^-1/2), k and v [B, Lk, D] (v scaled by 1/L of
// the whole sequence), all in the compute dtype T (bf16 on the product path,
// f32 in the checks), per head h:
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
// across key blocks; here one block per (64-query tile, batch row) walks the
// key tiles itself, with the offset added to every distance; tiles whose
// pairs all lie in the future are skipped, and the causal mask applies per
// element only where a distance is negative.
//
// - pair_fwd_wgmma_kernel<W> (bf16 with head slices in whole 16-byte chunks
//   at most 128 wide, padded to W = 16-128 columns: every ring preset): one
//   warpgroup owns one query tile with all its heads, the heaviest tiles
//   first, and runs the attention loop of the single device's
//   attn_ffn_wgmma_kernel (attn_issue, attn_step of csrc/fused_block_sm90
//   .cuh): a two-stage cp.async ring streams, per head and key tile k0 <=
//   q0 + 63 + off (k0 < Lk), k_h, v_h, the keys' valid flags and the tile's
//   127 biases; S = q_h k_h^T is an SS wgmma, silu, bias and mask are
//   applied in registers (unmasked where every pair is in the past and every
//   key valid), and T(a) feeds acc += T(a) v_h as an RS wgmma. Each head's
//   f32 sum is stored from the accumulator (8-byte stores, the head's own
//   columns); a tile that sees no key stores zeros. Ragged shards (lengths
//   multiples of 16) load zero rows and invalid flags past their ends.
// - pair_fwd_kernel<T>, the first design (f32, the tight check instance,
//   and wider heads): WMMA 16x16x16 through shared memory where hd % 16 ==
//   0 in bf16, FMA loops otherwise, with a barrier between each product and
//   the SiLU pass.
//
// The backward (ring_pair_dq, ring_pair_dkdv) launches the HSTU attention
// backward of csrc/hstu_attn_bwd_sm90.cuh, the kernels the single-device
// fused backward launches too (wgmma kernels in bf16 at hd <= 128): dq with
// the rel-pos gradient summed per diagonal of each tile into per-(query
// tile, row) partials, which reduce_rows_split_kernel sums in a fixed order
// (no atomics, so the result is deterministic), and dk/dv.
//
// Bound on the H100 per pair of shards of Lc tokens at D = 64, B = 32:
// forward 2 B D Lc^2 (causal pair: half of that) products, f32 partial out;
// at Lc = 2048 a full pair is 17.2 GFLOP, 17 us at 989 TFLOP/s bf16, against
// 42 MB of q, k, v, the flags and the f32 partial (13 us at 3.35 TB/s):
// compute bound, as is the backward (four products of that size). The
// wgmma kernel's registers leave room for 4 blocks an SM at W <= 64.

#include "fused_block_common.cuh"
#include "fused_block_sm90.cuh"
#include "hstu_attn_bwd_sm90.cuh"

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

// The wgmma forward: one warpgroup per (64-query tile, batch row), with
// all its heads; the q tiles held for the whole block, k, v and the row
// data of each (head, key tile) step through a two-stage cp.async ring.
template <int W>
__host__ __device__ inline sm90::Carve<W> fwd_carve(int H) {
  return sm90::Carve<W>{H, 2, 0};
}

template <int W>
__global__ void __launch_bounds__(fb90::kWg, W <= 64 ? 4 : 2)
    pair_fwd_wgmma_kernel(PairArgs p) {
  constexpr int kR = fb90::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  const sm90::Carve<W> cv = fwd_carve<W>(p.H);
  const int D = p.D, H = p.H, hd = D / H, NB = p.NB;
  const int b = blockIdx.y, qt = gridDim.x - 1 - blockIdx.x, q0 = qt * kR;
  const int nq = min(kR, p.Lq - q0);   // this tile's queries in the shard
  // key tiles 0 .. n - 1 hold a pair at distance >= 0 (k0 <= q0 + 63 + off)
  const int last = q0 + kR - 1 + p.off;
  const int n = last < 0 ? 0 : min((p.Lk + kR - 1) / kR, last / kR + 1);
  const int steps = H * n;
  const size_t rowq = (size_t)b * p.Lq + q0, rowk = (size_t)b * p.Lk;
  const bf16* K = static_cast<const bf16*>(p.k) + rowk * D;
  const bf16* V = static_cast<const bf16*>(p.v) + rowk * D;
  float* out = p.av + rowq * D;

  // the first group also carries the query tiles
  if (steps > 0)
    for (int h = 0; h < H; ++h)
      fb90::load_mat<W>(cv.held(base, h),
                        kR, static_cast<const bf16*>(p.q) + rowq * D + h * hd,
                        D, nq, hd);
  auto issue = [&](int s) {
    if (s < steps) {
      const int h = s / n, k0 = (s - h * n) * kR, st = s % sm90::kStages;
      fb90::attn_issue<W, true>(
          cv.tile(base, st, 0), cv.tile(base, st, 1), cv.rows(base, st),
          K + (size_t)k0 * D + h * hd, V + (size_t)k0 * D + h * hd,
          p.valid + rowk + k0, p.rab + (size_t)h * NB, D, hd, p.Lk - k0,
          q0 + p.off - k0, NB);
    }
    sm90::cp_async_commit();
  };

  // head h's sum (0 where the tile sees no key) to its columns, nq rows
  float acc[W / 2], s[32];
  const int r0 = sm90::acc_row(0), c0 = sm90::acc_col(0);
  auto store = [&](int h) {
#pragma unroll
    for (int i = 0; i < W / 2; i += 2) {
      const int r = sm90::acc_row(i), c = sm90::acc_col(i);
      if (c < hd && r < nq)
        *reinterpret_cast<float2*>(out + (size_t)r * D + h * hd + c) =
            make_float2(acc[i], acc[i + 1]);
      acc[i] = acc[i + 1] = 0.0f;
    }
  };
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  if (steps == 0) {
    for (int h = 0; h < H; ++h) store(h);
    return;
  }
  issue(0);
  for (int step = 0; step < steps; ++step) {
    issue(step + 1);
    sm90::cp_async_wait<1>();
    sm90::fence_async_smem();
    const int h = step / n, kt = step - h * n, st = step % sm90::kStages;
    fb90::attn_step<W>(acc, s, cv.held(base, h), cv.tile(base, st, 0),
                       cv.tile(base, st, 1), cv.rows(base, st),
                       q0 + p.off - kt * kR, r0, c0, 1.0f);
    if (kt == n - 1) store(h);
    __syncthreads();  // this stage is read; a later issue reloads it
  }
}

// Which instance of the forward runs: pair_fwd_wgmma_kernel in bf16 where
// the attention loop takes the heads (fb90::attn_heads, the condition
// attn_ffn_wgmma_kernel's attention has: every ring preset), the first
// design pair_fwd_kernel in f32 (the tight check instance) and for other
// heads. A launch the chosen instance cannot make fails: the wrapper raises.
inline bool pair_fwd_wgmma_route(const PairArgs& p, bool is_bf16) {
  return is_bf16 && fb90::attn_heads(p.D, p.H);
}

template <int W>
int launch_fwd_wgmma(const PairArgs& p, cudaStream_t stream) {
  // the operands it streams with cp.async and stores in 8-byte pairs: a
  // misaligned one fails the launch (the wrapper checks their alignment)
  if (!sm90::aligned16(p.q) || !sm90::aligned16(p.k) ||
      !sm90::aligned16(p.v) || !sm90::aligned16(p.av))
    return (int)cudaErrorInvalidValue;
  return hstu_bwd::launch_kernel(
      pair_fwd_wgmma_kernel<W>,
      dim3((p.Lq + fb90::kRows - 1) / fb90::kRows, p.B), fb90::kWg,
      fwd_carve<W>(p.H).bytes(), stream, p);
}

int launch_fwd_wgmma_any(const PairArgs& p, cudaStream_t stream) {
  switch (sm90::wgmma_width(p.D / p.H)) {
    case 16: return launch_fwd_wgmma<16>(p, stream);
    case 32: return launch_fwd_wgmma<32>(p, stream);
    case 64: return launch_fwd_wgmma<64>(p, stream);
    default: return launch_fwd_wgmma<128>(p, stream);
  }
}

// Widest tile (64, 32 or 16 rows) dividing both lengths whose shared memory
// fits; 0 if none.
template <typename T>
int pick_tile(const PairArgs& p) {
  for (int t = 64; t >= 16; t >>= 1)
    if (p.Lq % t == 0 && p.Lk % t == 0 && fwd_smem<T>(p.D, t) <= kMaxSmem)
      return t;
  return 0;
}

// The backward's arguments: dq w.r.t. the scaled q (scale 1).
hstu_bwd::AttnBwdArgs attn_args(const PairArgs& p) {
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
  a.Lq = p.Lq;
  a.Lk = p.Lk;
  a.D = p.D;
  a.H = p.H;
  a.NB = p.NB;
  a.off = p.off;
  a.dq_scale = 1.0f;
  return a;
}

template <typename T>
int launch(const PairArgs& p, int which, cudaStream_t stream) {
  if (which != 0)
    return hstu_bwd::launch<T>(attn_args(p), which == 1, which == 2, stream);
  if (pair_fwd_wgmma_route(p, std::is_same<T, bf16>::value))
    return launch_fwd_wgmma_any(p, stream);
  const int TT = pick_tile<T>(p);
  if (TT == 0) return (int)cudaErrorInvalidValue;
  const size_t sm = fwd_smem<T>(p.D, TT);
  cudaError_t e = cudaFuncSetAttribute(
      pair_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (e != cudaSuccess) return (int)e;
  pair_fwd_kernel<T><<<dim3(p.Lq / TT, p.B), kThreads, sm, stream>>>(
      p, TT, std::is_same<T, bf16>::value);
  return (int)cudaGetLastError();
}

int dispatch(int is_bf16, const PairArgs* args, int which, void* stream) {
  const PairArgs& p = *args;
  if (p.Lq % 16 != 0 || p.Lk % 16 != 0 || p.D % 16 != 0 || p.H <= 0 ||
      p.D % p.H != 0 || p.NB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<bf16>(p, which, s);
  return launch<float>(p, which, s);
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
