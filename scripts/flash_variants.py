#!/usr/bin/env python3
"""Where the flash MHA kernels' time goes, on one NVIDIA H100.

    python3 scripts/flash_variants.py [--rounds 2]

Builds the committed ``csrc/flash_attention.cu`` and edited copies of it,
each with one part of the bf16 ``wgmma`` kernels taken out, then times every
build's forward and backward (CUDA events, 20 calls after 3) at the four
flash shapes of ``chip_smoke.ATTN_SHAPES``, in turns, ``--rounds`` times.
The committed build is first checked against the plain versions. The
edited copies compute wrong numbers on purpose: they only say how much of
the time each part takes.

- ``fwd_noexp``, ``bwd_noexp``: the exponentials become identities;
- ``fwd_noload``, ``bwd_noload``: the ring loads only its first tile (the
  streamed tiles' copies cost nothing);
- ``fwd_nopv``: no T(P).V product (its operands stay live);
- ``fwd_dense``: every tile takes the unmasked elementwise path.

Prints the card's name and power limit, then one line per build and round:
``name: shape fwd_ms/bwd_ms ...``. Builds go to build/flash_variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FWD = ("flash_fwd_wgmma_kernel(FlashArgs p) {",
       "flash_bwd_dq_wgmma_kernel(FlashArgs p) {")
BWD = ("flash_bwd_dq_wgmma_kernel(FlashArgs p) {", "// launch")


def edit(text, region, old, new):
    """``text`` with ``old`` replaced by ``new`` between the region's two
    markers; raises if ``old`` is not there."""
    a, b = text.index(region[0]), text.index(region[1])
    if old not in text[a:b]:
        raise ValueError(f"{old!r} not in the region of {region[0]!r}")
    return text[:a] + text[a:b].replace(old, new) + text[b:]


def variants(src: str) -> dict:
    xor = " ^ ".join(f"a[{i}][{j}]" for i in range(4) for j in range(4))
    v = {"committed": src,
         "fwd_noexp": edit(src, FWD, "sm90::exp2_approx(", "("),
         "fwd_noload": edit(src, FWD, "if (s < 2 * n) {",
                            "if (s < kStages - 1) {"),
         "fwd_nopv": edit(src, FWD,
                          "accumulate<W>(o, a, cv.tile(base, st, 1));",
                          f"o[0] += __uint_as_float({xor});"),
         "fwd_dense": edit(src, FWD, "const bool dense = full && kt != qt;",
                           "const bool dense = true;"),
         "bwd_noexp": edit(src, BWD, "sm90::exp2_approx(", "(")}
    noload = edit(src, BWD, "if (s < 2 * n) {", "if (s < kStages - 1) {")
    v["bwd_noload"] = edit(noload, BWD, "if (s < n) {",
                           "if (s < kStages - 1) {")
    return v


def build(builds: dict, out: Path) -> dict:
    """One nvcc per build, all at once; returns name -> library path."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    procs = {}
    for name, text in builds.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention.cu").write_text(text)
        for h in kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
               str(d / "lib.so"), str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: out / name / "lib.so" for name in builds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    print(CS.card_line(), flush=True)
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    libs = build(variants(src), ROOT / "build" / "flash_variants")
    bf16 = torch.bfloat16
    shapes = [s for s in CS.ATTN_SHAPES if s[0] == "flash"]
    inputs = {run: CS.attention_inputs(B, L, D, H, bf16, 50)
              for _, run, B, L, D, H in shapes}
    ok = True
    for rnd in range(args.rounds):
        for name, lib in libs.items():
            kernels._LIBS["flash_attention"] = ctypes.CDLL(str(lib))
            line = []
            for _, run, B, L, D, H in shapes:
                q, k, v, dout, valid, _ = inputs[run]
                out, st = FA.flash_mha_fwd(q, k, v, valid, H,
                                           return_stats=True)
                if name == "committed" and rnd == 0:
                    good = CS.compare_attn(out, FA.flash_mha_fwd_plain(
                        q, k, v, valid, H), bf16)[0]
                    for g, w in zip(
                            FA.flash_mha_bwd(q, k, v, dout, valid, H, st),
                            FA.flash_mha_bwd_plain(q, k, v, dout, valid, H)):
                        good &= CS.compare_grad(g, w, bf16)[0]
                    ok &= good
                    line.append(f"[{run} matches plain: {good}]")
                tf = CS.time_ms(lambda: FA.flash_mha_fwd(q, k, v, valid, H),
                                3, 20)
                tb = CS.time_ms(lambda: FA.flash_mha_bwd(
                    q, k, v, dout, valid, H, st), 3, 20)
                line.append(f"{run} {tf:.4f}/{tb:.4f}")
            print(f"round {rnd} {name}: " + "  ".join(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
