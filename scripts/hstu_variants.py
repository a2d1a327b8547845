#!/usr/bin/env python3
"""Where the standalone HSTU attention's wgmma kernels spend their time, on
one NVIDIA H100.

    python3 scripts/hstu_variants.py [--rounds 2]

Builds the committed ``csrc/hstu_attention.cu`` and edited copies of it
(each with its own copy of the ``csrc/*.cuh`` it includes, some of those
edited), each with one part of ``hstu_fwd_wgmma_kernel`` or of the
backward pair's standalone instance (``attn_bwd_dq_wgmma_kernel<W, 1>``,
``attn_bwd_dkdv_wgmma_kernel<W, 1>``) taken out, then times every build's
kernels alone (device ms by the profiler over 10 calls after 1, of the
chunked route's wrappers) at ``mini_long``'s shape (B=32, L=4096, D=64,
H=4: heads of 16) and at one head of 64 (B=32, L=4096, D=64, H=1) in
bf16, in turns, ``--rounds`` times. The committed build is first checked
against the plain versions. The edited copies compute wrong numbers on
purpose: they only say how much of the time each part takes.

- ``fwd_nosilu``: the forward's silu is the identity (no ex2, no rcp);
- ``fwd_dense``: every tile takes the unmasked path;
- ``fwd_nopv``: no T(a) v product (the silu feeding it is dead code too:
  what is left is the loads and S = qs k^T);
- ``bwd_nosilu``: the backward's silu and dsilu are the identity and 1;
- ``bwd_dense``: every tile takes the unmasked path;
- ``bwd_norel``: every dq tile sums its ds into the clamped bucket (no
  per-diagonal rel-pos sums through shared memory);
- ``dq_4blocks``: not a part taken out but the dq kernel held to 128
  registers (``__launch_bounds__(128, 4)``: 4 blocks an SM), which the
  standalone instance exceeds (154 at W = 16) and the fused one does not.

Prints the card's name and power limit, each build's registers and
spills, then one line per build and round: ``name: shape fwd ms bwd ms``.
Builds go to build/hstu_variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the files each build compiles: the source and the headers it includes
FILES = ("hstu_attention.cu", "fused_block_sm90.cuh",
         "hstu_attn_bwd_sm90.cuh")
STEP = ("__device__ __forceinline__ void attn_step(", "}  // namespace fb90")
BWD = ("attn_bwd_dq_wgmma_kernel(AttnBwdArgs p) {", "// launch")
DQ = ("attn_bwd_dq_wgmma_kernel(AttnBwdArgs p) {",
      "attn_bwd_dkdv_wgmma_kernel(AttnBwdArgs p) {")


def edit(files, name, region, old, new, count=1):
    """``files`` with ``old`` replaced by ``new`` in ``name`` between the
    region's two markers; raises unless ``old`` is there ``count`` times."""
    text = files[name]
    a, b = text.index(region[0]), text.index(region[1])
    if text[a:b].count(old) != count:
        raise ValueError(f"{old!r} is not {count} times in the region of "
                         f"{region[0]!r}")
    return dict(files, **{name: text[:a] + text[a:b].replace(old, new)
                          + text[b:]})


SILU = "__device__ __forceinline__ void silu_pair("
IDENTITY = ("__device__ __forceinline__ void identity_pair(float v, float& a,"
            " float& g) {\n  a = v;\n  g = 1.0f;\n}\n\n")


def variants(files: dict) -> dict:
    """name -> {file name: text}"""
    sm90, bwd = "fused_block_sm90.cuh", "hstu_attn_bwd_sm90.cuh"
    nosilu = edit(files, bwd, BWD, "silu_pair(s[i] + rw[",
                  "identity_pair(s[i] + rw[", count=2)
    nosilu[bwd] = nosilu[bwd].replace(SILU, IDENTITY + SILU)
    dense = edit(files, bwd, DQ, "if (full && based - (kTile - 1) >= 0)",
                 "if (true)")
    dense = edit(dense, bwd, BWD,
                 "if (kv0 && kv1 && based - (kTile - 1) >= 0)", "if (true)")
    return {
        "committed": files,
        "fwd_nosilu": edit(files, sm90, STEP,
                           "fast_silu(s[i] + rw[r - c + kRows - 1]);",
                           "(s[i] + rw[r - c + kRows - 1]);"),
        "fwd_dense": edit(files, sm90, STEP,
                          "if (full && based >= kRows - 1)", "if (true)"),
        "fwd_nopv": edit(files, sm90, STEP,
                         "sm90::accumulate<W>(acc, a, vt);", ""),
        "bwd_nosilu": nosilu,
        "bwd_dense": dense,
        "bwd_norel": edit(files, bwd, DQ,
                          "if (based - (kTile - 1) >= NB - 1) {",
                          "if (true) {"),
        "dq_4blocks": edit(files, bwd, ("template <int W, bool kStandalone>",
                                        "attn_bwd_dkdv_wgmma_kernel("),
                           "__launch_bounds__(kWg)\n    attn_bwd_dq_wgmma",
                           "__launch_bounds__(kWg, 4)\n    attn_bwd_dq_wgmma"),
    }


def build(builds: dict, out: Path) -> dict:
    """One nvcc per build, all at once; returns name -> (library path, the
    standalone wgmma kernels' registers and spills, as text)."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    procs = {}
    for name, files in builds.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h in kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        for fname, text in files.items():
            (d / fname).write_text(text)
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
               str(d / "lib.so"), str(d / "hstu_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = "; ".join(
            f"{k['kernel']} {k['registers']} registers, spills "
            f"{k['spill_stores']}/{k['spill_loads']} B"
            for k in kernels.ptxas_report(log)
            if k["kernel"].startswith("hstu_fwd_wgmma")
            or k["kernel"].endswith(", 1>"))
        built[name] = (out / name / "lib.so", regs)
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("hstu_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    print(CS.card_line(), flush=True)
    files = {f: (kernels.CSRC / f).read_text() for f in FILES}
    libs = build(variants(files), ROOT / "build" / "hstu_variants")
    for name, (_, regs) in libs.items():
        print(f"{name}: {regs}", flush=True)
    bf16 = torch.bfloat16
    inputs = {f"H={H}": CS.attention_inputs(32, 4096, 64, H, bf16, 52)
              for H in (4, 1)}
    ok = True
    for rnd in range(args.rounds):
        for name, (path, _) in libs.items():
            kernels._LIBS["hstu_attention"] = ctypes.CDLL(str(path))
            line = []
            for shape, (q, k, v, dout, valid, rab) in inputs.items():
                H, L = rab.shape[0], q.shape[1]

                def fwd():
                    return HA.hstu_attention_chunk_fwd(q, k, v, valid, rab,
                                                       L, H)

                def bwd():
                    return HA.hstu_attention_chunk_bwd(q, k, v, dout, valid,
                                                       rab, L, H)

                if name == "committed" and rnd == 0:
                    good = CS.compare_attn(fwd(), HA.hstu_attention_fwd_plain(
                        q, k, v, valid, rab, L, H), bf16)[0]
                    CS._free()
                    want = HA.hstu_attention_bwd_plain(q, k, v, dout, valid,
                                                       rab, L, H)
                    good &= all(CS.compare_grad(g, w, bf16)[0]
                                for g, w in zip(bwd(), want))
                    del want
                    CS._free()
                    ok &= good
                    line.append(f"[{shape} matches plain: {good}]")
                f_ms = CS.kernel_device_ms(fwd, CS.HSTU_WGMMA[:1])
                b_ms = CS.kernel_device_ms(bwd, CS.HSTU_WGMMA[1:])
                line.append(f"{shape} fwd {f_ms:.4f} bwd {b_ms:.4f}")
            print(f"round {rnd} {name}: " + "  ".join(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
