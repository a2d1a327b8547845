// Exact top-k maximum inner product search over an f32 corpus, for Hopper,
// sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the exact scan to XLA
// (tencent_recommendation_2025_tpu/retrieval/mips.py, a blocked product and
// lax.top_k). The port's plain version (retrieval/mips.py::
// _topk_mips_plain) scores [Q, 65,536] blocks with an f32 GEMM, concatenates
// the running winners onto each block and takes torch.topk's radix select:
// at Q = 1024 over 10M x 64 rows, 1.65 ms of data movement and selection a
// block around 0.3 ms of products. Only the top k of each query leaves the
// scan, so here no score reaches device memory.
//
//   mips_scan_kernel<TM>: grid (query tiles, slices), the query tiles of one
//       slice adjacent in launch order, so that they read its rows together
//       and mostly from L2. A block holds BM = 16 TM queries (TM = 1, 2
//       or 4; two blocks an SM) in shared memory (zero past Q and past D)
//       and streams its slice of corpus
//       rows, 128 rows a tile, through a three-stage cp.async ring of
//       32-column chunks. Each of its 256 threads keeps a TM x 8 register
//       tile of scores (queries ty + 16 i, rows tx + 16 j; a warp's lanes
//       hold all 128 rows of its 2 TM queries), summed over the columns in
//       ascending order with f32 FFMA from 0 (no TF32, no lower precision;
//       pad columns add 0). After a tile, a score enters a query's
//       candidate slots only if it beats the query's running k-th (one
//       compare a score, against the 64 FFMAs of D = 64), and the warp that
//       holds the query merges the slots into its sorted top k in shared
//       memory, with no block barrier. A query whose slots overflow keeps
//       the scores in registers and offers them again after the merge. Each block writes its slice's k winners (score, corpus
//       row) to scratch [S, Q, k].
//   mips_merge_kernel: one warp a query merges the S slices' lists into the
//       final top k and writes (score, base + row) in int64; places no row
//       filled hold (lowest f32, 0), as the plain version.
//
// Order, everywhere: score descending, then row ascending (lax.top_k's
// choice among tied scores), so no tie needs a second scan. Rows at or past
// n (a shard's pad rows past n_valid - base) are never scored.
//
// Bound on the H100: operations. 2QND f32 operations outside the tensor
// cores (Q = 1024, N = 10M, D = 64: 1.31e12, about 20 ms at 67 TFLOP/s),
// against 2.56 GB of corpus read once (0.76 ms). Per 4 columns a thread
// issues TM + 8 16-byte shared loads for 32 TM FFMAs; staged rows are 36
// floats and query rows an odd number of 16-byte groups apart, so that the
// 16 rows a warp reads at once take two wavefronts, its 2 queries one.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;            // corpus rows a tile
constexpr int kRJ = 8;                // rows a thread: tx + 16 j
constexpr int kKC = 32;               // columns a stage
constexpr int kPitchB = kKC + 4;      // floats a staged row
constexpr int kStages = 3;
constexpr int kCap = 32;              // candidate slots a query
constexpr int kMaxK = 128;
constexpr int kMaxD = 1024;
constexpr int kMergeWarps = 8;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ float pos_inf() {
  return __uint_as_float(0x7f800000u);
}

// (s1, r1) ranks before (s2, r2): the higher score, then the lower row
__device__ __forceinline__ bool before(float s1, int r1, float s2, int r2) {
  return s1 > s2 || (s1 == s2 && r1 < r2);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (4) bytes to shared memory, of which the first `bytes` from src and the
// rest zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements of the sorted (s, r)[0, n) that rank before (x, xr).
__device__ __forceinline__ int lower(const float* s, const int* r, int n,
                                     float x, int xr) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(s[mid], r[mid], x, xr)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Elements of the sorted (s, r)[0, n) that rank before (x, xr) or equal it.
__device__ __forceinline__ int upper(const float* s, const int* r, int n,
                                     float x, int xr) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!before(x, xr, s[mid], r[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Elements of the unsorted (s, r)[0, n) that rank before (x, xr).
__device__ __forceinline__ int count_before(const float* s, const int* r,
                                            int n, float x, int xr) {
  int c = 0;
  for (int j = 0; j < n; ++j) c += before(s[j], r[j], x, xr);
  return c;
}

// One warp: the sorted list (ls, lr)[0, k) becomes the top k of itself and
// the candidates (cs, cr)[0, c) (c <= kMaxK; sorted where kSorted). Each
// element's place is its rank among both; on equal elements the list's
// ranks first (a slice's unfilled places repeat the sentinels).
template <bool kSorted>
__device__ __forceinline__ void warp_merge(float* ls, int* lr, int k,
                                           const float* cs, const int* cr,
                                           int c) {
  constexpr int M = kMaxK / 32;
  const int lane = threadIdx.x & 31;
  float ys[M], xs[M];
  int yr[M], xr[M], yk[M], xk[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = lane + 32 * m;
    yk[m] = xk[m] = INT_MAX;
    ys[m] = xs[m] = 0.f;
    yr[m] = xr[m] = 0;
    if (i < k) {
      ys[m] = ls[i];
      yr[m] = lr[i];
      yk[m] = i + (kSorted ? lower(cs, cr, c, ys[m], yr[m])
                           : count_before(cs, cr, c, ys[m], yr[m]));
    }
    if (i < c) {
      xs[m] = cs[i];
      xr[m] = cr[i];
      xk[m] = (kSorted ? i : count_before(cs, cr, c, xs[m], xr[m]))
              + upper(ls, lr, k, xs[m], xr[m]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (yk[m] < k) {
      ls[yk[m]] = ys[m];
      lr[yk[m]] = yr[m];
    }
    if (xk[m] < k) {
      ls[xk[m]] = xs[m];
      lr[xk[m]] = xr[m];
    }
  }
  __syncwarp();
}

struct ScanArgs {
  const float* q;        // [Q, D], rows ldq floats apart
  const float* corpus;   // [>= n, D], rows D floats apart
  float* part_s;         // [S, Q, k]: each slice's winners, sorted
  int* part_r;           // [S, Q, k]: their corpus rows
  int Q, D, k;
  int pa;                // floats a query row in shared memory
  int n;                 // rows scored: [0, n)
  int rows;              // rows a slice, a multiple of kRows
  int aligned;           // corpus rows in whole 16-byte vectors
  long long ldq;
};

// floats a query row takes in shared memory: D rounded up to 4, an odd
// number of 16-byte groups
int query_pitch(int D) {
  int pa = (D + 3) & ~3;
  if ((pa / 4) % 2 == 0) pa += 4;
  return pa;
}

size_t scan_smem(int bm, int pa, int k) {
  return sizeof(float) * ((size_t)bm * pa + (size_t)kStages * kRows * kPitchB
                          + 2 * (size_t)bm * k + 2 * (size_t)bm * kCap + bm);
}

// acc[i][j] += the product of columns [kk, kk + 4) of the staged rows (bs)
// and the queries (as: the query tile at the chunk's first column), in
// column order.
template <int TM>
__device__ __forceinline__ void product4(float (&acc)[TM][kRJ],
                                         const float* as, int pa,
                                         const float* bs, int kk, int ty,
                                         int tx) {
  float4 av[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * pa + kk);
#pragma unroll
  for (int j = 0; j < kRJ; ++j) {
    const float4 b =
        *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kPitchB + kk);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      acc[i][j] = fmaf(av[i].x, b.x, acc[i][j]);
      acc[i][j] = fmaf(av[i].y, b.y, acc[i][j]);
      acc[i][j] = fmaf(av[i].z, b.z, acc[i][j]);
      acc[i][j] = fmaf(av[i].w, b.w, acc[i][j]);
    }
  }
}

// Offers the scores of a tile (rows r0 + tx + 16 j, below hi; queries
// ty + 16 i, below qn) that beat their query's k-th to its candidate slots:
// all of them (kAll) or those of `mask`. A score that finds the slots full
// sets its bit in `over`. Returns whether any score was offered. With kAll,
// a branch-free pass first asks whether any score reaches its query's
// k-th: after a slice's first tiles almost none does (on an H100 at
// Q = 1024 over 10M x 64, 44 ms without the pass, 41-42 with it).
template <int TM, bool kAll>
__device__ __forceinline__ int offer(const float (&acc)[TM][kRJ],
                                     unsigned long long mask,
                                     unsigned long long& over, int r0,
                                     int hi, int qn, int k, const float* Ls,
                                     const int* Lr, float* Cs, int* Cr,
                                     int* Cn, int ty, int tx) {
  if (kAll) {
    bool reach = false;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qq = ty + 16 * i;
      const float ts = qq < qn ? Ls[qq * k + k - 1] : pos_inf();
#pragma unroll
      for (int j = 0; j < kRJ; ++j) reach |= acc[i][j] >= ts;
    }
    if (!reach) return 0;
  }
  int any = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qq = ty + 16 * i;
    if (qq >= qn) continue;
    const float ts = Ls[qq * k + k - 1];
    const int tr = Lr[qq * k + k - 1];
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      const int r = r0 + tx + 16 * j;
      const unsigned long long bit = 1ull << (i * kRJ + j);
      if ((kAll || (mask & bit)) && r < hi
          && before(acc[i][j], r, ts, tr)) {
        any = 1;
        const int pos = atomicAdd(Cn + qq, 1);
        if (pos < kCap) {
          Cs[qq * kCap + pos] = acc[i][j];
          Cr[qq * kCap + pos] = r;
        } else {
          over |= bit;
        }
      }
    }
  }
  return any;
}

// A tile's scores into the queries' top k, by the warp that holds them: a
// warp's lanes hold all 128 rows of its 2 TM queries (ty = 2 warp and
// 2 warp + 1), so a query's candidates, merge and k-th involve no other
// warp. Offered, then the candidates merged (the warp's queries with
// candidates found by a ballot), until every score that beats its query's
// k-th is in.
template <int TM>
__device__ __forceinline__ void select_tile(const float (&acc)[TM][kRJ],
                                            int r0, int hi, int qn, int k,
                                            float* Ls, int* Lr, float* Cs,
                                            int* Cr, int* Cn, int ty,
                                            int tx) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // lane l < 2 TM minds the warp's query 2 warp + (l & 1) + 16 (l >> 1)
  const int mine = 2 * warp + (lane & 1) + 16 * (lane >> 1);
  unsigned long long over = 0ull;   // scores that found the slots full
  int any = offer<TM, true>(acc, 0ull, over, r0, hi, qn, k, Ls, Lr, Cs, Cr,
                            Cn, ty, tx);
  while (__any_sync(kAll, any)) {
    __syncwarp();
    const int cn = lane < 2 * TM ? Cn[mine] : 0;
    unsigned todo = __ballot_sync(kAll, cn != 0);
    const int full = __any_sync(kAll, cn > kCap);
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      const int qq = __shfl_sync(kAll, mine, l);
      warp_merge<false>(Ls + qq * k, Lr + qq * k, k, Cs + qq * kCap,
                        Cr + qq * kCap,
                        min(__shfl_sync(kAll, cn, l), kCap));
      if (lane == 0) Cn[qq] = 0;
    }
    __syncwarp();
    if (!full) return;
    const unsigned long long mask = over;
    over = 0ull;
    any = offer<TM, false>(acc, mask, over, r0, hi, qn, k, Ls, Lr, Cs, Cr,
                           Cn, ty, tx);
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
mips_scan_kernel(ScanArgs a) {
  constexpr int BM = 16 * TM;
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, D = a.D, pa = a.pa;
  float* As = smem;                                   // [BM][pa]
  float* Bs = As + BM * pa;                           // [kStages][kRows][36]
  float* Ls = Bs + kStages * kRows * kPitchB;         // [BM][k]
  int* Lr = reinterpret_cast<int*>(Ls + BM * k);      // [BM][k]
  float* Cs = reinterpret_cast<float*>(Lr + BM * k);  // [BM][kCap]
  int* Cr = reinterpret_cast<int*>(Cs + BM * kCap);   // [BM][kCap]
  int* Cn = Cr + BM * kCap;                           // [BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = 2 * warp + (lane >> 4), tx = lane & 15;
  const int q0 = blockIdx.x * BM;
  const int qn = min(BM, a.Q - q0);
  const int lo = blockIdx.y * a.rows;
  const int hi = min(lo + a.rows, a.n);

  for (int e = tid; e < BM * pa; e += kThreads) {
    const int qq = e / pa, c = e - qq * pa;
    As[e] = (qq < qn && c < D) ? a.q[(q0 + qq) * a.ldq + c] : 0.f;
  }
  for (int e = tid; e < BM * k; e += kThreads) {
    Ls[e] = neg_inf();
    Lr[e] = INT_MAX - k + e % k;      // sentinels: after every real row
  }
  for (int e = tid; e < BM; e += kThreads) Cn[e] = 0;

  const int tiles = (hi - lo + kRows - 1) / kRows;
  const int chunks = (D + kKC - 1) / kKC;
  const int steps = tiles * chunks;

  // step -> tile step / chunks, columns from (step % chunks) * kKC
  auto load = [&](int step) {
    const int t = step / chunks, c0 = (step - t * chunks) * kKC;
    float* dst = Bs + (step % kStages) * kRows * kPitchB;
    const int r0 = lo + t * kRows;
#pragma unroll
    for (int v = 0; v < kRows * kKC / 4 / kThreads; ++v) {
      const int e = tid + v * kThreads, r = e / (kKC / 4);
      const int c = e % (kKC / 4) * 4;
      const int row = r0 + r, col = c0 + c;
      float* d = dst + r * kPitchB + c;
      const float* src = a.corpus + (long long)row * D + col;
      if (a.aligned) {
        const bool in = row < hi && col < D;
        cp_async16(d, in ? src : a.corpus, in ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = row < hi && col + u < D;
          cp_async4(d + u, in ? src + u : a.corpus, in ? 4 : 0);
        }
      }
    }
  };

  float acc[TM][kRJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < steps) load(step + kStages - 1);
    cp_async_commit();
    const int t = step / chunks, c0 = (step - t * chunks) * kKC;
    const float* bs = Bs + (step % kStages) * kRows * kPitchB;
    const int w = min(kKC, D - c0);
    if (w == kKC) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 4)
        product4<TM>(acc, As + c0, pa, bs, kk, ty, tx);
    } else {
      for (int kk = 0; kk < w; kk += 4)
        product4<TM>(acc, As + c0, pa, bs, kk, ty, tx);
    }
    if (c0 + kKC >= D) {               // the tile's last chunk
      select_tile<TM>(acc, lo + t * kRows, hi, qn, k, Ls, Lr, Cs, Cr, Cn,
                      ty, tx);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kRJ; ++j) acc[i][j] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int qq = warp; qq < qn; qq += kThreads / 32) {
    const long long o = ((long long)blockIdx.y * a.Q + q0 + qq) * k;
    for (int i = lane; i < k; i += 32) {
      a.part_s[o + i] = Ls[qq * k + i];
      a.part_r[o + i] = Lr[qq * k + i];
    }
  }
}

struct MergeArgs {
  const float* part_s;   // [S, Q, k]
  const int* part_r;     // [S, Q, k]
  float* out_s;          // [Q, k]
  long long* out_i;      // [Q, k]
  long long base;        // global row of corpus row 0
  int Q, k, S;
};

__global__ void __launch_bounds__(kMergeWarps * 32)
mips_merge_kernel(MergeArgs a) {
  __shared__ float ls_all[kMergeWarps][kMaxK];
  __shared__ int lr_all[kMergeWarps][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= a.Q) return;
  const int k = a.k;
  float* ls = ls_all[warp];
  int* lr = lr_all[warp];
  for (int i = lane; i < k; i += 32) {
    ls[i] = neg_inf();
    lr[i] = INT_MAX - k + i;
  }
  __syncwarp();
  for (int s = 0; s < a.S; ++s) {
    const long long o = ((long long)s * a.Q + q) * k;
    if (!before(a.part_s[o], a.part_r[o], ls[k - 1], lr[k - 1])) continue;
    warp_merge<true>(ls, lr, k, a.part_s + o, a.part_r + o, k);
  }
  for (int i = lane; i < k; i += 32) {
    const float s = ls[i];
    const bool real = s > -FLT_MAX;
    a.out_s[(long long)q * k + i] = real ? s : -FLT_MAX;
    a.out_i[(long long)q * k + i] = real ? a.base + lr[i] : 0;
  }
}

template <int TM>
int launch_scan(const ScanArgs& a, int slices, cudaStream_t stream) {
  const size_t smem = scan_smem(16 * TM, a.pa, a.k);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mips_scan_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((a.Q + 16 * TM - 1) / (16 * TM));
  mips_scan_kernel<TM><<<dim3(tiles, (unsigned)slices), kThreads, smem,
                         stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Q, D] f32 (rows ldq floats apart), corpus [>= n, D] f32 (rows D floats
// apart), part_s / part_r [slices, Q, k] f32 / int32 scratch. Scans corpus rows [0, n) in slices of
// `rows` (a multiple of 128; every slice non-empty) with query tiles of 16 tm
// (tm 1, 2 or 4). Returns a cudaError_t code (0 on success).
extern "C" int mips_topk_scan(const void* q, const void* corpus,
                              void* part_s, void* part_r, int Q, int D,
                              int k, int n, int rows, int slices, int tm,
                              int aligned, long long ldq, void* stream) {
  if (Q <= 0 || D <= 0 || ldq < D || D > kMaxD || k <= 0 || k > kMaxK || n <= 0
      || n > INT_MAX - kMaxK || rows <= 0 || rows % kRows != 0
      || slices <= 0 || (long long)(slices - 1) * rows >= n
      || (long long)slices * rows < n || slices > 65535)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{static_cast<const float*>(q), static_cast<const float*>(corpus),
             static_cast<float*>(part_s), static_cast<int*>(part_r), Q, D,
             k, query_pitch(D), n, rows, aligned, ldq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 1: return launch_scan<1>(a, slices, s);
    case 2: return launch_scan<2>(a, slices, s);
    case 4: return launch_scan<4>(a, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// part_s / part_r [slices, Q, k] from mips_topk_scan (slices may be 0: no
// row scanned); out_s [Q, k] f32, out_i [Q, k] int64: base + row.
extern "C" int mips_topk_merge(const void* part_s, const void* part_r,
                               void* out_s, void* out_i, int Q, int k,
                               int slices, long long base, void* stream) {
  if (Q <= 0 || k <= 0 || k > kMaxK || slices < 0)
    return (int)cudaErrorInvalidValue;
  MergeArgs a{static_cast<const float*>(part_s),
              static_cast<const int*>(part_r), static_cast<float*>(out_s),
              static_cast<long long*>(out_i), base, Q, k, slices};
  const unsigned blocks = (unsigned)((Q + kMergeWarps - 1) / kMergeWarps);
  mips_merge_kernel<<<blocks, kMergeWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
