#!/usr/bin/env python3
"""Time the fused HSTU block's forward and backward and the ring's pair
kernels of one checkout of the port, on one NVIDIA H100, for a comparison
of two commits in one machine's turns.

    python3 scripts/fused_bwd_ab.py ROOT TAG

ROOT is the root of a checkout (this one, or an older commit unpacked with
``git archive`` into a git-ignored directory); its package and its kernels
(built under ROOT/build/) are the ones timed. The inputs, timers and
digests are those of the ``chip_smoke.py`` beside this script, so that both
sides take the same inputs. Run it once per side in turns, each side its
own process:

    for t in parent change change parent; do
        r=$([ $t = parent ] && echo build/parent || echo .)
        (cd $r && python3 "$OLDPWD/scripts/fused_bwd_ab.py" "$PWD" $t)
    done

Times, in bf16 with the flagship's dropout: ``fused_hstu_block`` (the
inference forward), ``fused_hstu_block_train`` and ``fused_hstu_block_bwd``
at the flagship (B=128, L=1024, D=64, H=1), long (B=32, L=4096) and sparse
(B=64, L=1024, H=4) shapes, CUDA events over 20 calls after 3 (the
backward 10 after 2), with the device ms of each kernel name in one
profiled call of the training forward and the backward; the ring's pair
kernels at the S =
2 shard (B=32, Lc=2048), the mean over offsets 0, 0 and +Lc:
``ring_pair_fwd`` (``pair_fwd_wgmma_kernel`` on wgmma, ``pair_fwd_kernel``
before it) by CUDA events and by its kernel's device ms, ``ring_pair_dq``,
``ring_pair_dkdv``; and the pre stage and its backward there
(``ring_pre_fwd``, ``ring_pre_bwd``: bf16 dq, dk, dv and f32 du); and
``chip_smoke.bitwise_digests()`` (sha256 of the fused block's forward and
backward outputs and of the ring's pair kernels'), which two commits that
compute the same numbers share bitwise. Prints ``tree TAG <package
file>``, then one line ``AB {json}``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("fused_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tree", tag, FB.__file__, flush=True)
    kernels.build_all(["fused_block", "fused_block_bwd", "ring_pair"])
    bf16 = torch.bfloat16
    out = {"tag": tag, "card": cs.card_line()}

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {k[:40]: round(v, 4)
                for k, v in cs._device_ms(prof).most_common(8)}

    for name, shp in (("flagship", cs.FLAGSHIP), ("long", cs.LONG),
                      ("sparse", dict(cs.FLAGSHIP, B=64, H=4))):
        H = shp["H"]
        x, ops, tt = cs.block_inputs(**shp, dtype=bf16, seed=12)
        av = FB.fused_hstu_block_train(x, ops, tt, H, 5, 0.01)[1]
        dout = torch.randn(x.shape, generator=torch.Generator(
            device="cuda").manual_seed(3), device="cuda").to(bf16)

        def fwd():
            return FB.fused_hstu_block(x, ops, tt, H)

        def train():
            return FB.fused_hstu_block_train(x, ops, tt, H, 5, 0.01)

        def bwd():
            return FB.fused_hstu_block_bwd(x, av, dout, ops, tt, H, 5, 0.01)

        out[name] = {"fwd_ms": cs.time_ms(fwd, 3, 20),
                     "train_ms": cs.time_ms(train, 3, 20),
                     "bwd_ms": cs.time_ms(bwd, 2, 10),
                     "device_train": device_ms(train),
                     "device": device_ms(bwd)}
        del x, ops, tt, av, dout
        cs._free()
    q, k, v, dav, valid, rab = cs._pair_inputs(32, 2048, 64, 1, bf16, 61)
    fwds = [lambda o=o: FB.ring_pair_fwd(q, k, v, valid, rab, o, 1)
            for o in (0, 0, 2048)]
    out["ring_fwd_ms"] = sum(cs.time_ms(f, 2, 10) for f in fwds) / 3
    out["ring_fwd_device_ms"] = sum(cs.kernel_device_ms(f, ("pair_fwd",))
                                    for f in fwds) / 3
    for w, fn in (("dq", FB.ring_pair_dq), ("dkdv", FB.ring_pair_dkdv)):
        ts = [cs.time_ms(lambda: fn(q, k, v, dav, valid, rab, o, 1), 2, 10)
              for o in (0, 0, 2048)]
        out[f"ring_{w}_ms"] = sum(ts) / 3
    x, ops, _ = cs.block_inputs(32, 2048, 64, 1, 256, 128, bf16, seed=62)
    u = FB.ring_pre_fwd(x, ops, 4096, 1)[3]
    out["ring_pre_fwd_ms"] = cs.time_ms(
        lambda: FB.ring_pre_fwd(x, ops, 4096, 1), 3, 20)
    out["ring_pre_bwd_ms"] = cs.time_ms(
        lambda: FB.ring_pre_bwd(x, ops, q, k, v, u, 4096, 1), 3, 20)
    out["digests"] = cs.bitwise_digests()
    print("AB", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
