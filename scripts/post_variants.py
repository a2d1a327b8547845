#!/usr/bin/env python3
"""Where the fused block's wgmma post-half and gate/FFN kernels spend their
time, on one NVIDIA H100.

    python3 scripts/post_variants.py [--rounds 2]

Builds the committed ``csrc/fused_block.cu`` and ``csrc/fused_block_bwd.cu``
and edited copies of them, each with one part of ``attn_ffn_wgmma_kernel``
or ``gate_ffn_bwd_wgmma_kernel`` taken out, then times every build's
kernel alone (device ms by the profiler over 10 calls after 1, of the
whole forward's or the ring's stage-0 backward wrapper) at the
flagship (B=128, L=1024, D=64, H=1) and sparse (B=64, H=4) shapes in bf16
with the flagship's dropout, in turns, ``--rounds`` times. The committed
builds are first checked against the plain versions. The edited copies
compute wrong numbers on purpose: they only say how much of the time each
part takes.

- ``gate_nostore``: the chunks' T(f) and T(dx13) are not written;
- ``gate_nohash``: no dropout masks (the hash is not computed);
- ``gate_noload``: the ring streams no weight after the first step;
- ``gate_nodout``: T(dout)'s fragments are zeros, not loaded per chunk;
- ``gate_nochunk``: no FFN chunk at all (projection, gate and tail only);
- ``fwd_noattn``: no attention step (the post half on whatever av holds);
- ``fwd_nopost``: no FFN chunk (attention, LN2, Wo and LN3 only);
- ``fwd_noexp``: the attention's silu is the identity.

Prints the card's name and power limit, then one line per build and round:
``name: shape ms ...``. Builds go to build/post_variants/.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GATE = ("gate_ffn_bwd_wgmma_kernel(BwdArgs p) {",
        "// One product over tokens")
FWD = ("attn_ffn_wgmma_kernel(Params p) {", "inline bool attn_ffn_wgmma_shape")


def edit(text, region, old, new):
    """``text`` with ``old`` replaced by ``new`` between the region's two
    markers; raises if ``old`` is not there."""
    a, b = text.index(region[0]), text.index(region[1])
    if old not in text[a:b]:
        raise ValueError(f"{old!r} not in the region of {region[0]!r}")
    return text[:a] + text[a:b].replace(old, new) + text[b:]


def variants(fwd: str, bwd: str) -> dict:
    """name -> (library, source text)"""
    return {
        "committed_bwd": ("fused_block_bwd", bwd),
        "gate_nostore": ("fused_block_bwd", edit(
            bwd, GATE, "if (j0 + c < F) {", "if (j0 + c < 0) {")),
        "gate_nohash": ("fused_block_bwd", edit(
            bwd, GATE, "const bool drop = p.seed != nullptr;",
            "const bool drop = false;")),
        "gate_noload": ("fused_block_bwd", edit(
            bwd, GATE, "if (s < steps) {", "if (s < 1) {")),
        "gate_nodout": ("fused_block_bwd", edit(
            bwd, GATE, "frags_of(dout, D, D, da);",
            "frags_of(dout, D, 0, da);")),
        "gate_nochunk": ("fused_block_bwd", edit(
            bwd, GATE, "for (int sc = 0; sc < CPS; ++sc) {",
            "for (int sc = 0; sc < 0; ++sc) {")),
        "committed_fwd": ("fused_block", fwd),
        "fwd_noattn": ("fused_block", edit(
            fwd, FWD, "const int na = attn ? H * n : 0;",
            "const int na = 0;")),
        "fwd_nopost": ("fused_block", edit(
            fwd, FWD, "const int nf = (F + FC - 1) / FC;",
            "const int nf = 0;")),
        "fwd_noexp": ("fused_block", edit(
            fwd, FWD, "fast_silu(s[i] + rw[r - c + kRows - 1]);",
            "(s[i] + rw[r - c + kRows - 1]);")),
    }


def build(builds: dict, out: Path) -> dict:
    """One nvcc per build, all at once; returns name -> library path."""
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    procs = {}
    for name, (lib, text) in builds.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{lib}.cu").write_text(text)
        for h in kernels.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
               str(d / "lib.so"), str(d / f"{lib}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: (builds[name][0], out / name / "lib.so")
            for name in builds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("post_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    print(CS.card_line(), flush=True)
    src = {n: (kernels.CSRC / f"{n}.cu").read_text()
           for n in ("fused_block", "fused_block_bwd")}
    libs = build(variants(src["fused_block"], src["fused_block_bwd"]),
                 ROOT / "build" / "post_variants")
    bf16, p = torch.bfloat16, CS.FLAGSHIP_DROPOUT
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    inputs = {}
    for name in ("flagship", "sparse"):
        B, L, D, H, F = CS.POST_SHAPES[name]
        x, ops, tt = CS.block_inputs(B, L, D, H, F, 128, bf16, 51)
        dout = torch.randn(x.shape, device="cuda").to(bf16)
        inputs[name] = (x, ops, tt, H, L, dout)
    ok = True
    for rnd in range(args.rounds):
        for name, (lib, path) in libs.items():
            kernels._LIBS[lib] = ctypes.CDLL(str(path))
            line = []
            for shape, (x, ops, tt, H, L, dout) in inputs.items():
                av = FB.fused_hstu_block_train_plain(
                    x, ops, tt, H, seed, p)[1] if (
                        name.startswith("committed") and rnd == 0) else \
                    (torch.randn(x.shape, device="cuda") * 0.05).to(bf16)
                if lib == "fused_block":
                    def fn():
                        return FB.fused_hstu_block_train(x, ops, tt, H,
                                                         seed, p)
                    names = ("attn_ffn_wgmma_kernel",)
                else:
                    def fn():
                        return FB.ring_post_bwd(x, av, dout, ops, seed, p, L,
                                                H)
                    names = ("gate_ffn_bwd_wgmma_kernel",)
                if name.startswith("committed") and rnd == 0:
                    if lib == "fused_block":
                        got = fn()
                        want = FB.fused_hstu_block_train_plain(
                            x, ops, tt, H, seed, p)
                        good = CS.compare(got[0], want[0], bf16)[0]
                    else:
                        got = fn()
                        want = FB.ring_post_bwd_plain(x, av, dout, ops, seed,
                                                      p, L, H)
                        good = all(CS.compare_grad(got[n], want[n], bf16)[0]
                                   for n in want)
                    ok &= good
                    line.append(f"[{shape} matches plain: {good}]")
                line.append(f"{shape} {CS.kernel_device_ms(fn, names):.4f}")
                del av
            print(f"round {rnd} {name}: " + "  ".join(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
