#!/usr/bin/env python3
"""The group gather's designs on one NVIDIA H100, in turns.

    python3 scripts/gather_variants.py [--rounds 2]

Builds the committed ``csrc/sparse_table.cu`` and edited copies of it, each
with one design of the gather in place of ``group_gather_kernel``:

- ``committed``: ``group_gather_kernel``, a warp a slot, the default cache
  policy;
- ``first``: the first design, the same kernel with streaming hints
  (``ld/st.global.cs``, as the scatter keeps);
- ``bulk``: persistent blocks, a few an SM, each an equal share of the
  slots; a chunk's ids staged in shared memory (the next chunk's by the
  other warps meanwhile); one thread moves the rows through the bulk-copy
  engine, pieces of up to 4 KB through a ring of 16 shared-memory stages
  (``cp.async.bulk`` global -> shared on an ``mbarrier``, then shared ->
  global as a bulk group), each load issued 8 pieces ahead of its store, a
  stage reused once its store has read it;
- ``register``: persistent warps, two slots a round with every vector of
  both rows in flight (``ld.global.nc.L1::no_allocate``), the next round's
  ids loaded first.

Each copy is held bitwise to the plain gather on the real slots (unsorted
slots with sentinels between them; rows of 16 B, 2 KB, 4 KB and a ragged
6000 or 12000 B). Then, at chip_smoke.py's case (1M groups of 1024, 196,608
slots, 190,000 real, sorted with a sentinel tail) in bf16 and f32, every
design and ``index_select`` of the real groups are timed in turns,
``--rounds`` times: CUDA events over 20 calls after a discarded pass of 20
(the first reading after the set-up ran high on some machines, the device
time not), and each kernel's device ms by the profiler. Prints the card's
name and power limit, then one line per design, dtype and round. Builds go
to build/gather_variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PERSISTENT = r'''// Blocks of `kernel` that share the card's SMs at `smem` bytes (at most
// `want`), after setting its shared memory; 0 on an error (in *err).
template <typename Kern>
int persistent_blocks(Kern kernel, int threads, size_t smem, long long want,
                      cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *err = e;
  if (e != cudaSuccess) return 0;
  const long long fit = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  return (int)(want < fit ? want : fit);
}

'''

BULK = r'''constexpr int kBulkThreads = 128;
constexpr int kChunk = 1024;     // slot ids a block stages at once
constexpr int kPiece = 4096;     // bytes of one bulk copy at most
constexpr int kStagesB = 16;     // shared-memory stages of a block
constexpr int kLag = 8;          // pieces loaded ahead of their stores
constexpr int kMinSlots = 64;    // slots a block takes at least

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               ::"r"(smem_u32(bar)) : "memory");
}

// bytes from src into shared dst, completing (one arrival and the bytes)
// on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// bytes of shared src to dst, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory: the two id buffers, the stages' mbarriers and the pieces'
// destinations, then the stages (each `piece` bytes, 128-byte aligned).
struct BulkCarve {
  static constexpr size_t kIds = 2 * kChunk * sizeof(int);
  static constexpr size_t kBars = kStagesB * sizeof(uint64_t);
  static constexpr size_t kDst = kStagesB * (sizeof(void*) + 4);
  static constexpr size_t kHead = (kIds + kBars + kDst + 127) & ~size_t(127);
  static size_t bytes(int piece) { return kHead + (size_t)kStagesB * piece; }
};

__global__ void __launch_bounds__(kBulkThreads)
group_gather_bulk_kernel(const unsigned char* table, const int* groups,
                         unsigned char* out, long long K, long long nG,
                         long long row_bytes, int piece) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BulkCarve::kIds);
  unsigned char** dsts = reinterpret_cast<unsigned char**>(
      smem + BulkCarve::kIds + BulkCarve::kBars);
  uint32_t* lens = reinterpret_cast<uint32_t*>(dsts + kStagesB);
  unsigned char* stages = smem + BulkCarve::kHead;
  const int tid = threadIdx.x;
  // this block's slots: an equal share of the K, in chunks of kChunk ids
  const long long per = (K + gridDim.x - 1) / gridDim.x;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = min(K, lo + per);

  // ids of the chunk from slot j0 into buffer `buf`, by warps 1-3 (thread
  // 0 issues the copies)
  auto stage_ids = [&](long long j0, int buf) {
    const int n = (int)min((long long)kChunk, hi - j0);
    for (int i = tid - 32; i < n; i += kBulkThreads - 32)
      ids[buf * kChunk + i] = __ldcs(groups + j0 + i);
  };
  if (tid == 0) {
    for (int s = 0; s < kStagesB; ++s) bar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid >= 32 && lo < hi) stage_ids(lo, 0);
  __syncthreads();

  // thread 0's pipeline over the pieces of every real group, in order:
  // piece `it` in stage it % kStagesB; its store once piece it + kLag is
  // loading
  long long it = 0;
  auto store_piece = [&](long long i) {
    const int st = (int)(i % kStagesB);
    bar_wait(bars + st, (uint32_t)((i / kStagesB) & 1));
    bulk_store(dsts[st], stages + (size_t)st * piece, lens[st]);
  };
  int buf = 0;
  for (long long j0 = lo; j0 < hi; j0 += kChunk, buf ^= 1) {
    if (tid == 0) {
      const int n = (int)min((long long)kChunk, hi - j0);
      for (int i = 0; i < n; ++i) {
        const long long g = ids[buf * kChunk + i];
        if (g < 0 || g >= nG) continue;    // sentinel slot: skipped
        const unsigned char* src = table + g * row_bytes;
        unsigned char* dst = out + (j0 + i) * row_bytes;
        for (long long o = 0; o < row_bytes; o += piece, ++it) {
          const int st = (int)(it % kStagesB);
          // the stage's last piece, it - kStagesB, is stored once the
          // kStagesB - kLag - 1 stores after it may still be pending
          bulk_wait_read<kStagesB - kLag - 1>();
          const uint32_t len = (uint32_t)min((long long)piece, row_bytes - o);
          dsts[st] = dst + o;
          lens[st] = len;
          bulk_load(stages + (size_t)st * piece, src + o, len, bars + st);
          if (it >= kLag) store_piece(it - kLag);
        }
      }
    } else if (tid >= 32 && j0 + kChunk < hi) {
      stage_ids(j0 + kChunk, buf ^ 1);
    }
    __syncthreads();   // the next chunk's ids are in; this chunk's are read
  }
  if (tid == 0) {
    for (long long i = it > kLag ? it - kLag : 0; i < it; ++i) store_piece(i);
    bulk_wait_all();
  }
}

int launch_gather_bulk(const void* table, const int* groups, void* out,
                       long long K, long long nG, long long row_bytes,
                       cudaStream_t s) {
  const int piece = (int)(row_bytes < kPiece ? row_bytes : kPiece);
  const size_t smem = BulkCarve::bytes(piece);
  cudaError_t e;
  const int blocks = persistent_blocks(group_gather_bulk_kernel,
                                       kBulkThreads, smem,
                                       (K + kMinSlots - 1) / kMinSlots, &e);
  if (e != cudaSuccess) return (int)e;
  group_gather_bulk_kernel<<<blocks, kBulkThreads, smem, s>>>(
      static_cast<const unsigned char*>(table), groups,
      static_cast<unsigned char*>(out), K, nG, row_bytes, piece);
  return (int)cudaGetLastError();
}
'''

REGISTER = r'''constexpr int kRegWarps = 8;    // warps a block
constexpr int kRegRows = 2;     // slots a warp copies at once
constexpr int kRegPer = 4;      // 16-byte vectors a lane loads per row

__device__ __forceinline__ uint4 ld_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Persistent warps: kRegRows slots a round, their rows' vectors all loaded
// before any is stored, the next round's ids loaded before the rows.
__global__ void __launch_bounds__(kRegWarps * 32)
group_gather_reg_kernel(const uint4* table, const int* groups, uint4* out,
                        long long K, long long nG, int vecs) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kRegWarps + threadIdx.x / 32;
  const long long stride = (long long)gridDim.x * kRegWarps * kRegRows;
  long long j0 = warp * kRegRows;
  int id = (lane < kRegRows && j0 + lane < K) ? __ldcs(groups + j0 + lane)
                                              : -1;
  for (; j0 < K; j0 += stride) {
    const long long jn = j0 + stride;
    const int next = (lane < kRegRows && jn + lane < K)
                         ? __ldcs(groups + jn + lane) : -1;
    long long g[kRegRows];
#pragma unroll
    for (int r = 0; r < kRegRows; ++r)
      g[r] = __shfl_sync(0xffffffffu, id, r);
    for (int base = 0; base < vecs; base += 32 * kRegPer) {
      uint4 v[kRegRows][kRegPer];
#pragma unroll
      for (int r = 0; r < kRegRows; ++r)
#pragma unroll
        for (int u = 0; u < kRegPer; ++u) {
          const int i = base + u * 32 + lane;
          if (g[r] >= 0 && g[r] < nG && i < vecs)
            v[r][u] = ld_nc(table + g[r] * vecs + i);
        }
#pragma unroll
      for (int r = 0; r < kRegRows; ++r)
#pragma unroll
        for (int u = 0; u < kRegPer; ++u) {
          const int i = base + u * 32 + lane;
          if (g[r] >= 0 && g[r] < nG && i < vecs)
            __stcs(out + (j0 + r) * vecs + i, v[r][u]);
        }
    }
    id = next;
  }
}

int launch_gather_reg(const void* table, const int* groups, void* out,
                      long long K, long long nG, long long row_bytes,
                      cudaStream_t s) {
  cudaError_t e;
  const int blocks = persistent_blocks(
      group_gather_reg_kernel, kRegWarps * 32, 0,
      (K + kRegRows * kRegWarps - 1) / (kRegRows * kRegWarps), &e);
  if (e != cudaSuccess) return (int)e;
  group_gather_reg_kernel<<<blocks, kRegWarps * 32, 0, s>>>(
      static_cast<const uint4*>(table), groups, static_cast<uint4*>(out), K,
      nG, (int)(row_bytes / 16));
  return (int)cudaGetLastError();
}
'''

LAUNCH = ("    group_gather_kernel<<<blocks, kWarps * 32, 0, s>>>(t, g, b, K, nG, "
          "vecs);\n")


def edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"{old!r} is not in sparse_table.cu once")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """name -> the source of that design."""
    anchor = "int launch(bool to_table,"
    out = {"committed": src,
           "first": edit(src, "constexpr bool kGatherStream = false;",
                         "constexpr bool kGatherStream = true;")}
    for name, code, fn in (("bulk", BULK, "launch_gather_bulk"),
                           ("register", REGISTER, "launch_gather_reg")):
        text = edit(src, anchor, PERSISTENT + code + "\n" + anchor)
        out[name] = edit(text, LAUNCH,
                         f"    return {fn}(table, g, buf, K, nG, row_bytes, "
                         "s);\n")
    return out


def build(builds: dict, out: Path) -> dict:
    """One nvcc per build, all at once; returns name -> loaded library."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    procs = {}
    for name, text in builds.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sparse_table.cu").write_text(text)
        for h in kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "sparse_table.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), d / "lib.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for k in kernels.ptxas_report(log):
            if "gather" in k["kernel"]:
                print(f"  {name}: {k['kernel']} {k['registers']} registers, "
                      f"spills {k['spill_stores']}/{k['spill_loads']} B",
                      flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    rounds = ap.parse_args().rounds
    import numpy as np
    import torch

    import chip_smoke as cs
    from tencent_recommendation_2025_tpu_torch.ops import kernels
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    if not torch.cuda.is_available():
        print("gather_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    libs = build(variants((kernels.CSRC / "sparse_table.cu").read_text()),
                 ROOT / "build" / "gather_variants")
    names = list(libs)

    def gather(name, table, g):
        kernels._LIBS["sparse_table"] = libs[name]
        return ST.group_gather(table, g)

    ok = True
    for dt in (torch.float32, torch.bfloat16):
        # rows of 16 B, 2 KB, 4 KB and a ragged 6000 or 12000 B
        for W in (16 // dt.itemsize, 2048 // dt.itemsize,
                  4096 // dt.itemsize, 3000):
            nG, K = 3000, 2777
            rng = np.random.default_rng(W)
            table = torch.randn((nG, W), generator=torch.Generator()
                                .manual_seed(0)).to(dt).cuda()
            slots = rng.permutation(nG)[:K].astype(np.int32)
            slots[rng.random(K) < 0.1] = nG
            g = torch.from_numpy(slots).cuda()
            real = g < nG
            want = ST.group_gather_plain(table, g)
            for name in names:
                same = torch.equal(gather(name, table, g)[real], want[real])
                ok &= same
                if not same:
                    print(f"{name} {str(dt)[6:]} W={W}: not equal to the "
                          f"plain gather", flush=True)
    print(f"every design bitwise equal to the plain gather: {ok}",
          flush=True)
    nG, W, K, n_real = (cs.GROUPS[k] for k in ("nG", "W", "K", "n_real"))
    slots = np.full((K,), nG, np.int32)
    slots[:n_real] = np.sort(np.random.default_rng(60).choice(
        nG, size=n_real, replace=False))
    g = torch.from_numpy(slots).cuda()
    real = g[:n_real].long()
    for dt in (torch.bfloat16, torch.float32):
        table = torch.randn((nG, W), generator=torch.Generator(
            device="cuda").manual_seed(61), device="cuda").to(dt)
        nbytes = 2 * n_real * W * table.element_size() + K * 4
        for rnd in range(rounds):
            for name in names + ["index_select"]:
                if name == "index_select":
                    def fn():
                        return table.index_select(0, real)
                    kname = ""
                else:
                    def fn(name=name):
                        return gather(name, table, g)
                    kname = "gather"
                cs.time_ms(fn, 3, 20)
                t = cs.time_ms(fn, 3, 20)
                d = cs.kernel_device_ms(fn, (kname,))
                print(f"{name} {str(dt)[6:]} round {rnd}: {t:.4f} ms (CUDA "
                      f"events), device {d:.4f} ms, {nbytes / d / 1e6:.1f} "
                      f"GB/s of the {nbytes / 1e6:.1f} MB bound "
                      f"({nbytes / cs.PEAK_BYTES * 1e3:.4f} ms)", flush=True)
        del table
        cs._free()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
