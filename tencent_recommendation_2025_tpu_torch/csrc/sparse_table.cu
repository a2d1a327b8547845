// Whole-group writes and reads of a sparse-trained embedding table, for
// Hopper, sm_90a.
//
// Replaces tencent_recommendation_2025_tpu/ops/sparse_table.py::
// pallas_group_scatter's kernel (l.424) with group_scatter_kernel, and
// pallas_group_gather's kernel (l.498) with group_gather_kernel. A table of
// 30M+ rows [Vp, D] is viewed as nG = Vp / R write groups of W = R * D =
// 1024 elements (R = 1024 / D rows; 2 KB in bf16, 4 KB in f32), row-major:
// the bytes of the JAX package's packed [Vp / R, 8, 128] table.
//
//   group_scatter: table[groups[j]] = arranged[j]   for every j with
//                  0 <= groups[j] < nG (the sentinel nG is skipped), in
//                  place: the table is the caller's buffer;
//   group_gather:  out[j] = table[groups[j]]        for the same j; the
//                  rows of a sentinel j are not written.
//
// groups [K] int32 (unique real groups, host_group_plan), arranged and out
// [K, W] in the table's dtype. The kernels copy bytes, so one instance
// serves every dtype.
//
// Design. The TPU kernel streams group ids HBM -> SMEM in 1024-id chunks
// and keeps 8 DMAs of one [8, 128] tile in flight. Here one warp owns one
// group: it reads its id and copies the row in 16-byte vectors, each lane
// loading all of its vectors before it stores any (8 in flight per lane in
// f32, 4 in bf16). Eight warps a block, one block per eight groups; the
// groups are unique, so no two warps write one address. Offsets are 64-bit:
// a 100M-row table holds 1.6e9 16-byte vectors. The scatter loads and
// stores with streaming hints (ld/st.global.cs: neither side is read again
// soon); the gather with the default policy, 0.2-2% faster by device time
// on the H100 and no slower than index_select (PERF.md row 21). Two
// redesigns of the gather lost to it on the same card and were not kept:
// persistent blocks moving whole rows through the bulk-copy engine
// (cp.async.bulk through a ring of shared-memory stages, one issuing
// thread, chunks of ids staged in shared memory) by 4-12%, and persistent
// warps with several rows and the next ids in flight by 3-6%
// (scripts/gather_variants.py times them in turns). At 88-89% of the
// card's memory rate the copy moves what the memory delivers to a gather
// of 2-4 KB rows.
//
// Bound on the H100: bytes. The scatter reads each real group's arranged
// row and writes it into the table, 2 * W * elem bytes a group, plus the
// 4-byte ids: a 65,536-group chunk of the 100M-row step in bf16 moves about
// 268 MB, 80 us at 3.35 TB/s. The gather moves the same bytes the other
// way: at 190,000 real groups of 196,608 slots, 779 MB in bf16 (0.2325 ms)
// and 1,557 MB in f32 (0.4649 ms).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;        // groups per block, one warp each
constexpr int kMaxVecs = 8;      // 16-byte vectors a lane keeps in flight

// One warp copies group row groups[j] of the table to or from row j of buf,
// with streaming cache hints where kStream.
template <bool kToTable, bool kStream>
__device__ __forceinline__ void copy_group(uint4* __restrict__ table,
                                           const int* __restrict__ groups,
                                           uint4* __restrict__ buf,
                                           long long K, long long nG,
                                           int vecs) {
  const long long j =
      (long long)blockIdx.x * kWarps + (long long)(threadIdx.x / 32);
  if (j >= K) return;
  const long long g = groups[j];
  if (g < 0 || g >= nG) return;            // sentinel group: skipped
  const int lane = threadIdx.x % 32;
  uint4* trow = table + g * vecs;
  uint4* brow = buf + j * vecs;
  const uint4* src = kToTable ? brow : trow;
  uint4* dst = kToTable ? trow : brow;
  for (int base = 0; base < vecs; base += 32 * kMaxVecs) {
    uint4 v[kMaxVecs];
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int i = base + u * 32 + lane;
      if (i < vecs) v[u] = kStream ? __ldcs(src + i) : src[i];
    }
#pragma unroll
    for (int u = 0; u < kMaxVecs; ++u) {
      const int i = base + u * 32 + lane;
      if (i < vecs) {
        if (kStream)
          __stcs(dst + i, v[u]);
        else
          dst[i] = v[u];
      }
    }
  }
}

// The gather's cache policy: the default one. chip_smoke.py builds a copy
// with streaming hints, the first design, to time it beside this.
constexpr bool kGatherStream = false;

__global__ void __launch_bounds__(kWarps * 32)
group_scatter_kernel(uint4* table, const int* groups, uint4* arranged,
                     long long K, long long nG, int vecs) {
  copy_group<true, true>(table, groups, arranged, K, nG, vecs);
}

__global__ void __launch_bounds__(kWarps * 32)
group_gather_kernel(uint4* table, const int* groups, uint4* out, long long K,
                    long long nG, int vecs) {
  copy_group<false, kGatherStream>(table, groups, out, K, nG, vecs);
}

int launch(bool to_table, void* table, const void* groups, void* buf,
           long long K, long long nG, long long row_bytes, void* stream) {
  if (K < 0 || nG < 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      row_bytes / 16 > (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const unsigned blocks = (unsigned)((K + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<uint4*>(table);
  auto* g = static_cast<const int*>(groups);
  auto* b = static_cast<uint4*>(buf);
  const int vecs = (int)(row_bytes / 16);
  if (to_table)
    group_scatter_kernel<<<blocks, kWarps * 32, 0, s>>>(t, g, b, K, nG, vecs);
  else
    group_gather_kernel<<<blocks, kWarps * 32, 0, s>>>(t, g, b, K, nG, vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// table: [nG, row_bytes] as bytes, 16-byte aligned; groups: [K] int32;
// arranged / out: [K, row_bytes], 16-byte aligned. Each returns a
// cudaError_t code (0 on success).
extern "C" int group_scatter(void* table, const void* groups,
                             const void* arranged, long long K, long long nG,
                             long long row_bytes, void* stream) {
  return launch(true, table, groups, const_cast<void*>(arranged), K, nG,
                row_bytes, stream);
}

extern "C" int group_gather(const void* table, const void* groups, void* out,
                            long long K, long long nG, long long row_bytes,
                            void* stream) {
  return launch(false, const_cast<void*>(table), groups, out, K, nG,
                row_bytes, stream);
}
