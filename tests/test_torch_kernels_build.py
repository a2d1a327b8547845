"""The kernel build's report (tencent_recommendation_2025_tpu_torch/ops/
kernels.py): each kernel's registers and spills as ``nvcc -Xptxas -v``
prints them, which chip_smoke.py logs after the build. Runs on the CPU: the
log is text; and a host compiler's check of every CUDA source."""

import re
import shutil
import subprocess

import pytest

from tencent_recommendation_2025_tpu_torch.ops import kernels

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f0b83912_18_flash_attention_cu_fec1e3f627flash_bwd_dkdv_wgmma_kernelILi128EEEvNS_9FlashArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f0b83912_18_flash_attention_cu_fec1e3f627flash_bwd_dkdv_wgmma_kernelILi128EEEvNS_9FlashArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 238 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__f0b83912_18_flash_attention_cu_fec1e3f621flash_bwd_dkdv_kernelI13__nv_bfloat16Li16EEEvNS_9FlashArgsEb' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__f0b83912_18_flash_attention_cu_fec1e3f621flash_bwd_dkdv_kernelI13__nv_bfloat16Li16EEEvNS_9FlashArgsEb
    8 bytes stack frame, 120 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN3fbk18reduce_rows_kernelEPKfiiPf' for 'sm_90a'
ptxas info    : Used 32 registers
"""


def test_ptxas_report_names_each_kernel_with_registers_and_spills():
    assert kernels.ptxas_report(LOG) == [
        {"kernel": "flash_bwd_dkdv_wgmma_kernel<128>", "registers": 238,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "flash_bwd_dkdv_kernel<nv_bfloat16, 16>",
         "registers": 255, "spill_stores": 120, "spill_loads": 96},
        {"kernel": "reduce_rows_kernel", "registers": 32,
         "spill_stores": 0, "spill_loads": 0}]


HSTU_LOG = """\
ptxas info    : Compiling entry function '_ZN8hstu_bwd24attn_bwd_dq_wgmma_kernelILi64EEEvNS_11AttnBwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN8hstu_bwd24attn_bwd_dq_wgmma_kernelILi64EEEvNS_11AttnBwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN8hstu_bwd26attn_bwd_dkdv_wgmma_kernelILi128EEEvNS_11AttnBwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN8hstu_bwd26attn_bwd_dkdv_wgmma_kernelILi128EEEvNS_11AttnBwdArgsE
    40 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN8hstu_bwd18attn_bwd_dq_kernelIfEEvNS_11AttnBwdArgsEib' for 'sm_90a'
ptxas info    : Used 90 registers
ptxas info    : Compiling entry function '_ZN8hstu_bwd20attn_bwd_dkdv_kernelI13__nv_bfloat16EEvNS_11AttnBwdArgsEib' for 'sm_90a'
ptxas info    : Used 128 registers
"""


def test_ptxas_report_names_the_attention_backward_kernels():
    """The HSTU attention backward's kernels (csrc/hstu_attn_bwd_sm90.cuh,
    namespace hstu_bwd): the wgmma instances by head width W, the generic
    ones by compute dtype. chip_smoke.py reads the spills of the wgmma
    kernels at W <= 64 from these names."""
    assert kernels.ptxas_report(HSTU_LOG) == [
        {"kernel": "attn_bwd_dq_wgmma_kernel<64>", "registers": 154,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "attn_bwd_dkdv_wgmma_kernel<128>", "registers": 255,
         "spill_stores": 36, "spill_loads": 36},
        {"kernel": "attn_bwd_dq_kernel<float>", "registers": 90,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "attn_bwd_dkdv_kernel<nv_bfloat16>", "registers": 128,
         "spill_stores": 0, "spill_loads": 0}]


STANDALONE_LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__7d1e2f3a_17_hstu_attention_cu_4b5c6d7e21hstu_fwd_wgmma_kernelILi16EEEvNS_8HstuArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__7d1e2f3a_17_hstu_attention_cu_4b5c6d7e21hstu_fwd_wgmma_kernelILi16EEEvNS_8HstuArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN8hstu_bwd24attn_bwd_dq_wgmma_kernelILi16ELb1EEEvNS_11AttnBwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN8hstu_bwd24attn_bwd_dq_wgmma_kernelILi16ELb1EEEvNS_11AttnBwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN8hstu_bwd26attn_bwd_dkdv_wgmma_kernelILi64ELb0EEEvNS_11AttnBwdArgsE' for 'sm_90a'
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_report_names_the_standalone_attention_kernels():
    """The standalone HSTU attention's wgmma forward (hstu_fwd_wgmma_kernel
    <W>) and the shared backward's instances by head width W and
    standalone flag (1: the standalone attention's, 0: the fused block's
    and the ring's): chip_smoke.fwd_spills and attn_bwd_spills read
    them by these names."""
    assert kernels.ptxas_report(STANDALONE_LOG) == [
        {"kernel": "hstu_fwd_wgmma_kernel<16>", "registers": 96,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "attn_bwd_dq_wgmma_kernel<16, 1>", "registers": 128,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "attn_bwd_dkdv_wgmma_kernel<64, 0>", "registers": 168,
         "spill_stores": 0, "spill_loads": 0}]


def test_ptxas_report_of_a_log_without_kernels_is_empty():
    assert kernels.ptxas_report("ptxas info    : 0 bytes gmem\n") == []


def test_library_name_covers_every_shared_header(tmp_path, monkeypatch):
    """An edit to a shared csrc/*.cuh (sm90_mma.cuh among them) renames
    every kernel library, so the next build compiles it anew."""
    for src in kernels.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels.library_path(n).name for n in kernels.SOURCES}
    header = tmp_path / "sm90_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: kernels.library_path(n).name for n in kernels.SOURCES}
    assert all(before[n] != after[n] for n in kernels.SOURCES)
    assert after["flash_attention"].startswith("libflash_attention-")


POST_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5e7a1c02_14_fused_block_cu_9b3f0d4121attn_ffn_wgmma_kernelILi64ELi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5e7a1c02_14_fused_block_cu_9b3f0d4121attn_ffn_wgmma_kernelILi64ELi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 246 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5e7a1c02_14_fused_block_cu_9b3f0d4121attn_ffn_wgmma_kernelILi16ELi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5e7a1c02_14_fused_block_cu_9b3f0d4121attn_ffn_wgmma_kernelILi16ELi128EEEvNS_6ParamsE
    144 bytes stack frame, 140 bytes spill stores, 140 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b25gate_ffn_bwd_wgmma_kernelILi32EEEv7BwdArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b25gate_ffn_bwd_wgmma_kernelILi32EEEv7BwdArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b18wgrad_wgmma_kernelENS_9WgradArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b18wgrad_wgmma_kernelENS_9WgradArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers
"""


def test_ptxas_report_names_the_post_half_and_gate_kernels():
    """The fused block's wgmma post half (attn_ffn_wgmma_kernel<W, DW>: head
    width, padded model width), gate/FFN backward (gate_ffn_bwd_wgmma_kernel
    <DW>) and weight-gradient kernel: chip_smoke.post_spills reads their
    spills from these names and fails on one at DW <= 64."""
    assert kernels.ptxas_report(POST_LOG) == [
        {"kernel": "attn_ffn_wgmma_kernel<64, 64>", "registers": 246,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "attn_ffn_wgmma_kernel<16, 128>", "registers": 255,
         "spill_stores": 140, "spill_loads": 140},
        {"kernel": "gate_ffn_bwd_wgmma_kernel<32>", "registers": 166,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "wgrad_wgmma_kernel", "registers": 72,
         "spill_stores": 0, "spill_loads": 0}]


PRE_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5e7a1c02_14_fused_block_cu_9b3f0d4117proj_wgmma_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5e7a1c02_14_fused_block_cu_9b3f0d4117proj_wgmma_kernelILi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b21proj_bwd_wgmma_kernelILi128EEEv7BwdArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b21proj_bwd_wgmma_kernelILi128EEEv7BwdArgs
    48 bytes stack frame, 44 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__1a2b3c4d_18_fused_block_bwd_cu_5e6f7a8b15proj_bwd_kernelI13__nv_bfloat16EEv7BwdArgsib' for 'sm_90a'
ptxas info    : Used 64 registers
"""


def test_ptxas_report_names_the_pre_half_kernels():
    """The fused block's wgmma pre half (proj_wgmma_kernel<DW> and
    proj_bwd_wgmma_kernel<DW>, DW the padded model width) beside the first
    design's proj_bwd_kernel<T>: chip_smoke.pre_spills reads the wgmma
    kernels' spills from these names and fails on one at DW <= 64."""
    assert kernels.ptxas_report(PRE_LOG) == [
        {"kernel": "proj_wgmma_kernel<64>", "registers": 96,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "proj_bwd_wgmma_kernel<128>", "registers": 255,
         "spill_stores": 44, "spill_loads": 44},
        {"kernel": "proj_bwd_kernel<nv_bfloat16>", "registers": 64,
         "spill_stores": 0, "spill_loads": 0}]


# ---------------------------------------------------------------------------
# a host compiler's syntax and type check of the CUDA sources
# ---------------------------------------------------------------------------
#
# No nvcc here: each csrc/*.cu goes through ``g++ -fsyntax-only`` with the
# kernel launches' <<<...>>> taken out and the CUDA headers replaced by the
# declarations below (device builtins, runtime calls, bf16 and WMMA types as
# the sources use them). Templates instantiate through each source's launch
# paths, so a misspelt name, a wrong argument list or an ambiguous overload
# in any kernel fails here before it reaches the card. Inline PTX is not
# checked: only the card's assembler reads it.

CUDA_RUNTIME_STUB = """\
#pragma once
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(...)
#define __restrict__
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern const uint3 threadIdx, blockIdx;
extern const dim3 gridDim, blockDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
float2 make_float2(float, float);
float4 make_float4(float, float, float, float);
uint2 make_uint2(unsigned, unsigned);
uint4 make_uint4(unsigned, unsigned, unsigned, unsigned);
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class T>
cudaError_t cudaFuncSetAttribute(T* f, cudaFuncAttribute a, int v);
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, T*, int,
                                                           size_t);
cudaError_t cudaGetDevice(int*);
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
cudaError_t cudaGetLastError();
void __syncthreads();
int __syncthreads_and(int);
int __syncthreads_or(int);
void __syncwarp(unsigned = 0xffffffffu);
int atomicAdd(int*, int);
unsigned __ballot_sync(unsigned, int);
int __any_sync(unsigned, int);
int __ffs(int);
template <class T> T __shfl_xor_sync(unsigned, T, int);
template <class T> T __shfl_sync(unsigned, T, int);
size_t __cvta_generic_to_shared(const void*);
template <class T> T __ldcs(const T*);
template <class T> void __stcs(T*, T);
float __expf(float);
float expf(float);
float rsqrtf(float);
float sqrtf(float);
float fmaf(float, float, float);
float fmaxf(float, float);
float fminf(float, float);
float __uint_as_float(unsigned);
unsigned __float_as_uint(float);
int min(int, int);
int max(int, int);
long long min(long long, long long);
long long max(long long, long long);
unsigned min(unsigned, unsigned);
unsigned max(unsigned, unsigned);
float min(float, float);
float max(float, float);
"""

CUDA_BF16_STUB = """\
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
__nv_bfloat16 __float2bfloat16_rn(float);
__nv_bfloat16 __float2bfloat16(float);
float __bfloat162float(__nv_bfloat16);
__nv_bfloat162 __floats2bfloat162_rn(float, float);
float2 __bfloat1622float2(__nv_bfloat162);
"""

MMA_STUB = """\
#pragma once
#include "cuda_bf16.h"
namespace nvcuda { namespace wmma {
struct matrix_a {}; struct matrix_b {}; struct accumulator {};
struct row_major {}; struct col_major {};
enum layout_t { mem_row_major, mem_col_major };
template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment { T x[8]; int num_elements; };
template <class F, class T> void load_matrix_sync(F&, const T*, unsigned);
template <class F, class T>
void load_matrix_sync(F&, const T*, unsigned, layout_t);
template <class F, class T>
void store_matrix_sync(T*, const F&, unsigned, layout_t);
template <class F, class T> void fill_fragment(F&, T);
template <class D, class A, class B, class C>
void mma_sync(D&, const A&, const B&, const C&);
}}
"""

SOURCES = sorted(p.name for p in kernels.CSRC.glob("*.cu"))


def _host_check(tmp_path, edit=None):
    """g++ -fsyntax-only over every csrc/*.cu and *.cuh copied into tmp_path
    without their launch configurations; ``edit`` (name -> text function)
    changes a copy first. Returns {source: (returncode, stderr)}."""
    for name, text in (("cuda_runtime.h", CUDA_RUNTIME_STUB),
                       ("cuda_bf16.h", CUDA_BF16_STUB), ("mma.h", MMA_STUB)):
        (tmp_path / name).write_text(text)
    for src in kernels.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            text = re.sub(r"<<<.*?>>>", "", src.read_text(), flags=re.S)
            if edit and src.name in edit:
                text = edit[src.name](text)
            (tmp_path / src.name).write_text(text)
    out = {}
    for name in SOURCES:
        r = subprocess.run(
            [shutil.which("g++") or "g++", "-x", "c++", "-std=c++17",
             "-fsyntax-only", "-I", str(tmp_path), str(tmp_path / name)],
            capture_output=True, text=True, timeout=300)
        out[name] = (r.returncode, r.stderr)
    return out


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    return _host_check(tmp_path_factory.mktemp("csrc"))


@pytest.mark.parametrize("source", SOURCES)
def test_cuda_source_passes_a_host_compiler_check(host_check, source):
    """Each kernel source (ring_pair.cu with pair_fwd_wgmma_kernel and the
    attention loop it shares with fused_block.cu's attn_ffn_wgmma_kernel,
    sparse_table.cu's gather among them) is well-formed C++ with every
    template instantiated."""
    rc, err = host_check[source]
    assert rc == 0, err[-4000:]


def test_host_compiler_check_catches_a_wrong_call(tmp_path):
    """The check is not vacuous: a call of the shared attention step with an
    argument too many fails it, in all three kernels that run the step
    (the fused block's, the ring's and the standalone HSTU attention's
    forward)."""
    def extra_arg(text):
        assert text.count("attn_step<W>(acc, s, ") >= 1
        return text.replace("attn_step<W>(acc, s, ", "attn_step<W>(acc, s, 0, ")

    callers = ("fused_block.cu", "ring_pair.cu", "hstu_attention.cu")
    out = _host_check(tmp_path, dict.fromkeys(callers, extra_arg))
    for name in callers:
        rc, err = out[name]
        assert rc != 0 and "attn_step" in err
    assert out["sparse_table.cu"][0] == 0


def test_host_compiler_check_instantiates_the_standalone_backward(tmp_path):
    """The standalone HSTU attention's instances of the shared backward
    (attn_bwd_*_wgmma_kernel<W, true>, bf16 outputs, launched from
    hstu_attention.cu) are instantiated by the check: without the bf16
    overload of store_pair, which only those instances and the standalone
    forward call, hstu_attention.cu fails and no other source does,
    although all three include the header."""
    def no_bf16_store(text):
        old = """__device__ __forceinline__ void store_pair(bf16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}
"""
        assert text.count(old) == 1
        return text.replace(old, "")

    out = _host_check(tmp_path, {"hstu_attn_bwd_sm90.cuh": no_bf16_store})
    rc, err = out["hstu_attention.cu"]
    assert rc != 0 and "store_pair" in err
    for name in ("fused_block_bwd.cu", "ring_pair.cu"):
        assert out[name][0] == 0, out[name][1][-2000:]


PAIR_GATHER_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1c2d3e4f_12_ring_pair_cu_5a6b7c8d21pair_fwd_wgmma_kernelILi64EEEv8PairArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__1c2d3e4f_12_ring_pair_cu_5a6b7c8d21pair_fwd_wgmma_kernelILi64EEEv8PairArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__1c2d3e4f_12_ring_pair_cu_5a6b7c8d15pair_fwd_kernelI13__nv_bfloat16EEv8PairArgsib' for 'sm_90a'
ptxas info    : Used 64 registers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1c2d3e4f_15_sparse_table_cu_5a6b7c8d19group_gather_kernelEP5uint4PKiS1_xxi' for 'sm_90a'
ptxas info    : Used 48 registers
"""


def test_ptxas_report_names_the_pair_forward_and_gather_kernels():
    """The ring's pair forward on wgmma (pair_fwd_wgmma_kernel<W>, W the
    padded head width) beside its first design and the group gather:
    chip_smoke.fwd_spills reads the wgmma kernel's registers and
    spills from these names and fails on a spill at W <= 64."""
    assert kernels.ptxas_report(PAIR_GATHER_LOG) == [
        {"kernel": "pair_fwd_wgmma_kernel<64>", "registers": 128,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "pair_fwd_kernel<nv_bfloat16>", "registers": 64,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "group_gather_kernel", "registers": 48,
         "spill_stores": 0, "spill_loads": 0}]
