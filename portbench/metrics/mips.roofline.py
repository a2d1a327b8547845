"""``retrieval/mips.py`` exact top-k: the f32 corpus read once (or 2QND at
the bf16 peak, the larger) over the device time under the top-k call, in
%."""

from portbench.bench import readers as RD


def read(run):
    return RD.mips_roofline(run)
