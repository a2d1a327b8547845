"""The kernel build's report (tencent_recommendation_2025_tpu_torch/ops/
kernels.py): each kernel's registers and spills as ``nvcc -Xptxas -v``
prints them, which chip_smoke.py logs after the build. Runs on the CPU: the
log is text."""

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
