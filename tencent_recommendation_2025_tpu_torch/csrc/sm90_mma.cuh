// Hopper (sm_90a) building blocks of the port's hand-written kernels:
// wgmma products with their accumulators in registers, the swizzled
// shared-memory tiles and descriptors they read, and a cp.async ring that
// fills those tiles while the previous tile is multiplied.
//
// Conventions (one warpgroup of 128 threads owns 64 rows of every product):
//
// - A bf16 tile of `rows` x W elements (W = 16, 32, 64 or 128: a head slice
//   padded to a power of two) is stored in column blocks of CW = min(W, 64)
//   elements, each block `rows` x CW row-major with rows of 2 CW bytes (32,
//   64 or 128), swizzled as the matching wgmma mode expects: the 16-byte
//   chunk index of a byte offset is XORed with the offset's bits 7 and up
//   (Tile<W>::offset). Every tile starts on a 1024-byte boundary. The same
//   tile serves as a K-major operand (its rows are the M or N index: q.k^T)
//   and as an MN-major one (its rows are the K index: p.v).
// - Accumulators follow wgmma's m64nN f32 layout: thread t of the
//   warpgroup holds, for column block j (8 columns) and v = 0..3, element
//   d[4 j + v] at row 16 (t / 32) + (t % 32) / 4 + 8 (v / 2) and column
//   8 j + 2 (t % 4) + v % 2 (acc_row, acc_col). A row's values sit in the
//   four threads of a quad: row reductions are two __shfl_xor.
// - frag_a turns 16 columns of a 64 x 64 f32 accumulator into the bf16 A
//   operand of a register-sourced (RS) wgmma, rounding to nearest: the
//   softmax probabilities feed p.v without leaving registers.
//
// Used by csrc/flash_attention.cu, csrc/hstu_attn_bwd_sm90.cuh (the HSTU
// attention backward of csrc/fused_block_bwd.cu and csrc/ring_pair.cu) and
// csrc/fused_block_sm90.cuh (the fused block's post half and gate/FFN
// backward).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kRows = 64;        // rows of one wgmma (M)
constexpr float kLog2e = 1.4426950408889634f;

// The tile width W (below) of a head of hd columns (0: wider than 128).
inline int wgmma_width(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 0;
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// kernels ask for 1024 bytes of slack).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// cp.async ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes (st.shared, cp.async) visible to
// the async proxy that wgmma reads through; a __syncthreads follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma issue and completion
// ---------------------------------------------------------------------------

// Orders this thread's register writes (accumulators, A fragments) before
// the wgmma that follows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait
// that completes it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// swizzled tiles and their descriptors
// ---------------------------------------------------------------------------

// wgmma's 64-bit shared-memory matrix descriptor: start address, leading
// and stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B); base offset 0 (tiles start on 1024-byte boundaries).
__device__ __forceinline__ uint64_t make_desc(uint32_t start, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return (uint64_t)((start & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (mode << 62);
}

template <int W>
struct Tile {
  static_assert(W == 16 || W == 32 || W == 64 || W == 128, "tile width");
  static constexpr int kCW = W < 64 ? W : 64;  // elements per column block
  static constexpr int kRB = 2 * kCW;          // bytes per block row
  static constexpr uint32_t kBits = kRB == 128 ? 3 : (kRB == 64 ? 2 : 1);
  static constexpr uint64_t kMode = kRB == 128 ? 1 : (kRB == 64 ? 2 : 3);

  static constexpr size_t bytes(int rows) { return (size_t)rows * W * 2; }

  // Byte offset of element (r, c) in a tile of `rows` rows; the 8
  // elements of an aligned 16-byte chunk stay together.
  __device__ static __forceinline__ uint32_t offset(int r, int c, int rows) {
    const uint32_t o = (uint32_t)((c / kCW) * rows * kRB + r * kRB +
                                  (c % kCW) * 2);
    return o ^ (((o >> 7) & ((1u << kBits) - 1u)) << 4);
  }

  __device__ static __forceinline__ bf16* at(bf16* t, int r, int c,
                                             int rows) {
    return reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(t) +
                                   offset(r, c, rows));
  }

  // The tile as a K-major operand (rows: M or N; columns: K), its k16
  // slice kk. LBO is unused by the swizzled K-major layouts.
  __device__ static __forceinline__ uint64_t desc_k(const bf16* t, int rows,
                                                    int kk) {
    const uint32_t start = smem_addr(t) + (kk * 16 / kCW) * rows * kRB +
                           (kk * 16 % kCW) * 2;
    return make_desc(start, 16, 8 * kRB, kMode);
  }

  // The tile as an MN-major operand (rows: K; columns: N), its k16 slice
  // kk: LBO steps between column blocks, SBO between 8-row groups.
  __device__ static __forceinline__ uint64_t desc_mn(const bf16* t, int rows,
                                                     int kk) {
    return make_desc(smem_addr(t) + kk * 16 * kRB, rows * kRB, 8 * kRB,
                     kMode);
  }
};

// The SiLU of a pre-activation q, k or v element in f32 (the standalone
// HSTU attention's silu_qkv), before it rounds to bf16: the sigmoid by the
// special-function unit (ex2.approx, rcp.approx), as the scores' SiLU
// takes it, since every block that streams a k, v or q tile applies it
// again.
__device__ __forceinline__ float silu_f32(float v) {
  float e, y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-v * kLog2e));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(1.0f + e));
  return v * y;
}

// One thread's share of the 16-byte chunks of a kRows x width tile (width
// <= W, a multiple of 8; source rows `ld` elements apart, in whole
// chunks), copied by all kWgThreads threads: chunk i = thread + 128 j is
// row i / (width / 8), column 8 (i % (width / 8)). Where width / 8 divides
// 128 (head dims 8, 16, 32, 64, 128) a thread's chunks share their column
// and lie 128 / (width / 8) rows apart (a multiple of 8: the same swizzle
// phase), so two offsets and two strides describe them all and each copy
// costs one add; other widths compute each chunk's place.
template <int W>
struct TileCopy {
  static constexpr int kMaxJ = W / 16;   // chunks per thread at most
  uint32_t soff = 0, sstep = 0;          // bytes in the tile
  uint32_t goff = 0, gstep = 0;          // elements in the source
  int cnt = 0, nch, ld;
  bool strided;

  __device__ TileCopy(int ld_, int width)
      : nch(width >> 3), ld(ld_), strided(nch > 0 && kWgThreads % nch == 0) {
    const int t = threadIdx.x, total = kRows * nch;
    if (strided) {
      const int r = t / nch, c = (t % nch) << 3, rs = kWgThreads / nch;
      soff = Tile<W>::offset(r, c, kRows);
      goff = (uint32_t)(r * ld + c);
      sstep = rs * Tile<W>::kRB;
      gstep = (uint32_t)(rs * ld);
      cnt = t < total ? (total - t + kWgThreads - 1) / kWgThreads : 0;
    }
  }

  // f(byte offset in the tile, element offset in the source) per chunk
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    if (strided) {
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j)
        if (j < cnt) f(soff + j * sstep, goff + j * gstep);
      return;
    }
    for (int i = threadIdx.x; i < kRows * nch; i += kWgThreads) {
      const int r = i / nch, c = (i - r * nch) << 3;
      f(Tile<W>::offset(r, c, kRows), (uint32_t)(r * ld + c));
    }
  }

  __device__ __forceinline__ void async(bf16* t, const bf16* src) const {
    unsigned char* tb = reinterpret_cast<unsigned char*>(t);
    each([&](uint32_t so, uint32_t go) { cp_async16(tb + so, src + go); });
  }

  // bf16(silu(f32(element)) * s), in place, on the chunks this thread
  // copied (the standalone HSTU attention's silu_qkv: one rounding; after
  // cp_async_wait, before the fence and barrier)
  __device__ __forceinline__ void silu(bf16* t, float s) const {
    unsigned char* tb = reinterpret_cast<unsigned char*>(t);
    each([&](uint32_t so, uint32_t) {
      uint4* q = reinterpret_cast<uint4*>(tb + so);
      uint4 raw = *q;
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(silu_f32(__bfloat162float(e[j])) * s);
      *q = raw;
    });
  }

  // bf16(f32(element) * scale), in place, on the chunks this thread copied
  // (after cp_async_wait, before the fence and barrier)
  __device__ __forceinline__ void scale(bf16* t, float s) const {
    unsigned char* tb = reinterpret_cast<unsigned char*>(t);
    each([&](uint32_t so, uint32_t) {
      uint4* q = reinterpret_cast<uint4*>(tb + so);
      uint4 raw = *q;
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * s);
      *q = raw;
    });
  }
};

// The same copy through registers, for any width and alignment; with
// `scaled` each element becomes bf16(f32(element) * scale), with kSilu
// bf16(silu(f32(element)) * scale) (the standalone HSTU attention's
// silu_qkv: one rounding; scale 1 for k and v). Vectorised (16 bytes a
// thread) where `vec`.
template <int W, bool kSilu = false>
__device__ __forceinline__ void load_tile_sync(bf16* t, const bf16* src,
                                               int ld, int rows, int width,
                                               int nthreads, bool vec,
                                               float scale, bool scaled) {
  if (vec) {
    const int nch = width >> 3;
    for (int i = threadIdx.x; i < rows * nch; i += nthreads) {
      const int r = i / nch, c = (i - r * nch) << 3;
      uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
      if constexpr (kSilu) {
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16_rn(silu_f32(__bfloat162float(e[j])) *
                                     scale);
      } else if (scaled) {
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
      }
      *reinterpret_cast<uint4*>(Tile<W>::at(t, r, c, rows)) = raw;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * width; i += nthreads) {
    const int r = i / width, c = i - r * width;
    const bf16 e = src[(size_t)r * ld + c];
    if constexpr (kSilu)
      *Tile<W>::at(t, r, c, rows) =
          __float2bfloat16_rn(silu_f32(__bfloat162float(e)) * scale);
    else
      *Tile<W>::at(t, r, c, rows) =
          scaled ? __float2bfloat16_rn(__bfloat162float(e) * scale) : e;
  }
}

// Zeroes `bytes` (a multiple of 16) of shared memory.
__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes,
                                          int nthreads) {
  for (size_t i = threadIdx.x * 16; i < bytes; i += (size_t)nthreads * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// Shared memory of a kernel that holds `fixed` tiles of kRows x W for the
// whole block and streams `per_stage` tiles through a ring of kStages
// stages, from a 1024-byte boundary: the held tiles, `extra` bytes of the
// block's own data (a multiple of 1024; key-valid flags, row stats, a
// scratch tile), then the stages, each its tiles and 1024 bytes of row
// data (key-valid flags, row stats, biases).
constexpr int kStages = 2;   // ring stages: loads run one tile ahead

template <int W>
struct Carve {
  static constexpr size_t kTileBytes = Tile<W>::bytes(kRows);
  int fixed, per_stage;
  size_t extra = 1024;

  __host__ __device__ size_t stage_bytes() const {
    return per_stage * kTileBytes + 1024;
  }
  __host__ __device__ size_t bytes() const {
    return 1024 + fixed * kTileBytes + extra + kStages * stage_bytes();
  }
  __device__ bf16* held(unsigned char* base, int i) const {
    return reinterpret_cast<bf16*>(base + i * kTileBytes);
  }
  __device__ unsigned char* held_rows(unsigned char* base) const {
    return base + fixed * kTileBytes;
  }
  __device__ unsigned char* stage(unsigned char* base, int s) const {
    return base + fixed * kTileBytes + extra + s * stage_bytes();
  }
  __device__ bf16* tile(unsigned char* base, int s, int i) const {
    return reinterpret_cast<bf16*>(stage(base, s) + i * kTileBytes);
  }
  __device__ unsigned char* rows(unsigned char* base, int s) const {
    return stage(base, s) + per_stage * kTileBytes;
  }
};

// ---------------------------------------------------------------------------
// accumulator layout, row reductions, A fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x >> 5) << 4) + ((threadIdx.x & 31) >> 2) +
         (((i >> 1) & 1) << 3);
}

__device__ __forceinline__ int acc_col(int i) {
  return ((i >> 2) << 3) + ((threadIdx.x & 3) << 1) + (i & 1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results below 2^-126 flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand (64 x 16, bf16) of columns 16 kk .. 16 kk + 15 of a 64 x 64
// f32 accumulator; kk must be a compile-time constant after unrolling.
__device__ __forceinline__ void frag_a(const float (&p)[32], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// the products (one warpgroup, m64, k16, bf16 operands, f32 accumulators)
// ---------------------------------------------------------------------------

// D[64 x 64] = (scale_d ? D : 0) + A . B^T: A [64 x 16] and B [64 x 16], bf16
// in shared memory, both K-major (descriptors from desc_k); with TA (TB) 1,
// A (B) is MN-major instead (desc_mn): D = A^T . B over the rows of two
// tiles whose rows are the K index (a product over tokens).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x 16] = (scale_d ? D : 0) + A . B: A [64 x 16] bf16 in registers
// (frag_a), B [16 x 16] bf16 in shared memory, MN-major (desc_mn).
template <int TB = 1>
__device__ __forceinline__ void mma_rs_n16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TB));
}

// D[64 x 32] = (scale_d ? D : 0) + A . B: A [64 x 16] bf16 in registers
// (frag_a), B [16 x 32] bf16 in shared memory, MN-major (desc_mn).
template <int TB = 1>
__device__ __forceinline__ void mma_rs_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TB));
}

// D[64 x 64] = (scale_d ? D : 0) + A . B: A [64 x 16] bf16 in registers
// (frag_a), B [16 x 64] bf16 in shared memory, MN-major (desc_mn).
template <int TB = 1>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TB));
}

// D[64 x 128] = (scale_d ? D : 0) + A . B: A [64 x 16] bf16 in registers
// (frag_a), B [16 x 128] bf16 in shared memory, MN-major (desc_mn).
template <int TB = 1>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d), "n"(TB));
}

// D[64 x W] = (scale_d ? D : 0) + A . B with B a W-wide MN-major tile
// (TB 1: its rows are the K index, desc_mn), or with TB 0 a K-major one
// (its W rows are the N index, desc_k: D = A . B^T).
template <int W, int TB = 1>
__device__ __forceinline__ void mma_rs(float (&d)[W / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  if constexpr (W == 16) mma_rs_n16<TB>(d, a, db, scale_d);
  else if constexpr (W == 32) mma_rs_n32<TB>(d, a, db, scale_d);
  else if constexpr (W == 64) mma_rs_n64<TB>(d, a, db, scale_d);
  else mma_rs_n128<TB>(d, a, db, scale_d);
}

// S (or S^T) = A . B^T over the W-column tiles a and b (kRows rows each,
// both K-major): the score products of the attention kernels.
template <int W>
__device__ __forceinline__ void scores(float (&s)[32], const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    mma_ss_n64(s, Tile<W>::desc_k(a, kRows, kk), Tile<W>::desc_k(b, kRows, kk),
               kk > 0 ? 1 : 0);
}

// acc += T(P) . B over the kRows rows of the MN-major tile b, P's bf16 A
// fragments (frag_a of a 64 x 64 accumulator) in a.
template <int W>
__device__ __forceinline__ void accumulate(float (&acc)[W / 2],
                                           const uint32_t (&a)[4][4],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<W>(acc, a[kk], Tile<W>::desc_mn(b, kRows, kk), 1);
}

}  // namespace sm90
