"""``ops/fused_block.py`` -> ``csrc/fused_block.cu``, ``fused_block_bwd.cu``:
the least time of every block launch of the profiled steps (forward and
backward bounds, PERF.md section 6 rows 1-2) over the device time of the
fused kernels, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.fused_block_roofline(run)
