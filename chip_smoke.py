#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device   — require CUDA; print the card's name and power limit
               (nvidia-smi --query-gpu=name,power.limit);
2. build    — compile every kernel under tencent_recommendation_2025_tpu_torch/
               csrc/ from the checkout (nvcc, sm_90a, one process per
               source, all at once), print the seconds;
3. kernels  — each kernel against its plain PyTorch version on the card, on
               seeded inputs with left padding and one fully padded row, at
               the stated tolerances: the fused block forward in inference
               and in training (with dropout, and its av output) and its
               backward, in the whole-sequence variant (L=1024 and 256) and
               in the chunked one (L > wholeseq_max_l(D): 2048, 4096 and
               16384 in f32 and bf16; D=128 and D=256 in f32), and whether
               the chunked variant's bf16 output follows its rounding point;
               then their times at both main paths' shapes (B=128, L=1024
               and B=32, L=4096; CUDA events) beside the plain versions' and
               their bounds;
4. training — a seeded synthetic fixture (1024 users, 5000 items, sequences
               of 256..1000 events) and the port's cli.train main with
               ``--preset hstu_flagship --maxlen 1023 --loader streaming
               --num_epochs 1`` on the card; checks the launch counts of the
               three kernels, finite losses and the checkpoint; then one
               step at full width and depth on 16 rows against the plain
               versions on the CPU in bf16 and in f32 (loss and per-leaf
               gradient cosine); prints train examples/s and a profile of
               one step;
5. serving  — the port's cli.infer main with the same arguments on the
               checkpoint just trained; checks the fused-block launch count,
               recomputes the first query batch with the plain versions on
               the CPU in bf16 and in f32 and holds the card's bf16 queries
               to both (per-query cosine); prints serving throughput and
               HR@10/NDCG@10 (one epoch on synthetic data: printed, not
               judged);
6. long     — phases 4 and 5 on long sequences, through the chunked
               variant: a fixture of 384 users, 5000 items and sequences of
               2048..4000 events, ``cli.train --maxlen 4095 --batch_size 32
               --loader cached --num_epochs 1`` (launch counts, losses,
               checkpoint, the cache build's seconds, examples/s and
               tokens/s of the step, a profile of one step), then
               ``cli.infer --maxlen 4095`` on that checkpoint with the first
               8 queries recomputed on the CPU;
7. report   — the card line, one JSON line listing every kernel, then the
               last line ``{"ok": true, "device": {...}}``.

Scratch data goes to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLAGSHIP = dict(B=128, L=1024, D=64, H=1, F=256, NB=128)
FLAGSHIP_DROPOUT = 0.01       # hstu_flagship's dropout_rate
# the training and serving runs: synthetic fixture and window (maxlen 1023
# gives L=1024, the kernels' shape); the model is hstu_flagship as it stands
FIXTURE = dict(num_users=1024, num_items=5000, min_seq=256, max_seq=1000,
               seed=21)
MAXLEN = 1023
# long sequences: L=4096 at the JAX package's long-sequence batch of 32
# (the flagship's 131,072 tokens per step), the chunked variant's path
LONG = dict(B=32, L=4096, D=64, H=1, F=256, NB=128)
LONG_FIXTURE = dict(num_users=384, num_items=5000, min_seq=2048,
                    max_seq=4000, seed=21)


@dataclasses.dataclass(frozen=True)
class Run:
    """One end-to-end path: its fixture, window, batch and cli.train
    arguments beyond ``--preset hstu_flagship --maxlen``."""
    name: str
    fixture: dict
    maxlen: int
    batch_size: int
    train_args: tuple
    work: Path
    n_check: int        # first queries recomputed on the CPU

    def args(self):
        return ["--preset", "hstu_flagship", "--maxlen", str(self.maxlen)]


# the L=1024 path keeps the streaming loader it has run with since its first
# slice (its one-step check reads that run's checkpoint); the long path
# takes the packed cache
FLAGSHIP_RUN = Run("flagship", FIXTURE, MAXLEN, 128,
                   ("--loader", "streaming"), WORK, 128)
LONG_RUN = Run("long", LONG_FIXTURE, 4095, 32,
               ("--batch_size", "32", "--loader", "cached"), WORK / "long", 8)
SRC = "tencent_recommendation_2025_tpu_torch/csrc/"
TPU = "tencent_recommendation_2025_tpu/ops/fused_block.py"
FWD_KERNELS = ("proj_kernel", "attn_ffn_kernel")
BWD_KERNELS = ("gate_ffn_bwd_kernel", "attn_dkdv_kernel", "attn_dq_kernel",
               "proj_bwd_kernel", "reduce_rows_kernel")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain
# ---------------------------------------------------------------------------

def block_inputs(B, L, D, H, F, NB, dtype, seed, device="cuda"):
    """Seeded kernel operands of one block (LN, biases and the rel-pos bias
    off their init) and inputs on ``device``: row 0 left-padded, the last
    row (B > 1) fully padded."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.config import ModelConfig
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    cfg = ModelConfig(hidden_units=D, num_heads=H, block_type="hstu",
                      ffn_type="swiglu", hstu_rel_pos_buckets=NB,
                      reference_init=False)
    assert ENC.swiglu_hidden_dim(D, cfg.ffn_hidden_mult,
                                 cfg.ffn_multiple_of) == F
    rng = np.random.default_rng(seed)
    bp = ENC.init_block_params(torch.Generator().manual_seed(seed), cfg)

    def perturb(t, key):
        if isinstance(t, dict):
            return {k: perturb(v, k) for k, v in t.items()}
        if key in ("b", "bias", "scale", "rab"):
            t = t + torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.1)
        return t.to(device)

    ops = FB.block_operands(perturb(bp, ""), dtype)
    x = torch.from_numpy(
        (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32))
    tt = np.ones((B, L), np.int32)
    tt[0, :L // 3 + 5] = 0
    if B > 1:
        tt[-1] = 0
    return x.to(dtype).to(device), ops, torch.from_numpy(tt).to(device)


def compare(out, ref, dtype):
    """(ok, max_abs_err, limit text) under the stated tolerance."""
    import torch

    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-4 + 1e-4 * r.abs()).all())
        return ok, err.max().item(), "rtol=1e-4 atol=1e-4"
    lim = 3e-2 * max(1.0, r.abs().max().item())
    cos = torch.nn.functional.cosine_similarity(
        o.reshape(-1, o.shape[-1]), r.reshape(-1, r.shape[-1]), dim=1)
    ok = err.max().item() <= lim and cos.min().item() >= 0.9995
    return ok, err.max().item(), (f"max_abs<={lim:.4g}, min token cosine "
                                  f"{cos.min().item():.6f} >= 0.9995")


def compare_grad(got, ref, dtype):
    """(ok, max_abs_err, limit text) for one gradient: f32 rtol 2e-4 and
    atol 2e-5 * max(1, max|ref|); bf16 cosine >= 0.999 and max abs <=
    3e-2 * max(1, max|ref|)."""
    import torch

    g, r = got.float().flatten(), ref.float().flatten()
    err = (g - r).abs()
    scale = max(1.0, r.abs().max().item())
    if dtype == torch.float32:
        ok = bool((err <= 2e-5 * scale + 2e-4 * r.abs()).all())
        return ok, err.max().item(), f"rtol=2e-4 atol={2e-5 * scale:.3g}"
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    ok = err.max().item() <= 3e-2 * scale and cos >= 0.999
    return ok, err.max().item(), (f"max_abs<={3e-2 * scale:.4g}, cosine "
                                  f"{cos:.6f} >= 0.999")


def time_ms(fn, warmup, iters):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _param_bytes(D, H, F, NB, elem_bytes):
    weights = (D * 4 * D + D * D + D * 2 * F + F * D) * elem_bytes
    return weights + (6 * D + 4 * D + D + H * NB) * 4


def fused_block_bound(B, L, D, H, F, elem_bytes, train=False, NB=128):
    """Least time (ms) of one fused block forward: the larger of its matmul
    operations over the peak rate and its bytes (inputs once, outputs once;
    training also writes av) over the memory rate. Causal: q.k^T and a.v
    each cost L(L+1)/2 key pairs per query row."""
    flops = (2 * B * L * D * 4 * D           # projection
             + 2 * B * D * L * (L + 1)        # q.k^T and a.v, causal
             + 2 * B * L * D * D              # Wo
             + 2 * B * L * D * 2 * F          # W13
             + 2 * B * L * F * D)             # W2
    acts = (3 if train else 2) * B * L * D * elem_bytes
    nbytes = acts + B * L * 4 + _param_bytes(D, H, F, NB, elem_bytes)
    return _bound(flops, nbytes)


def fused_block_bwd_bound(B, L, D, H, F, elem_bytes, NB=128):
    """Least time (ms) of one fused block backward (the TPU kernel's work,
    l.354-430): the recompute (projection, s, Wo, W13), the four attention
    products (dv, da, dq, dk, causal) and each weight product twice (dW and
    dX); bytes: x, av and dout in, dx out, the mask, the weights in and
    their f32 gradients out."""
    M = B * L
    causal = B * D * L * (L + 1)             # one causal [L, L] x D product
    flops = (2 * M * D * 4 * D + causal + 2 * M * D * D + 2 * M * D * 2 * F
             + 4 * causal
             + 2 * (2 * M * D * 4 * D + 2 * M * D * D + 2 * M * D * 2 * F
                    + 2 * M * F * D))
    grads = (D * 4 * D + D * D + D * 2 * F + F * D + 6 * D + 5 * D
             + H * NB) * 4
    nbytes = 4 * M * D * elem_bytes + M * 4 + \
        _param_bytes(D, H, F, NB, elem_bytes) + grads
    return _bound(flops, nbytes)


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_kernels(shp, dt, rate, seed):
    """One shape: the inference forward, the training forward (dropout at
    ``rate`` and its av output) and the backward against their plain
    versions on the same inputs; with dropout, the plain version with
    another seed must fail the limit the kernel passes."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    t0 = time.perf_counter()
    H = shp["H"]
    x, ops, tt = block_inputs(**shp, dtype=dt, seed=seed)
    out = FB.fused_hstu_block(x, ops, tt, H)
    torch.cuda.synchronize()
    ok0, e0, lim0 = compare(out, FB.fused_hstu_block_plain(x, ops, tt, H), dt)
    ok0 &= bool(torch.isfinite(out.float()).all())
    del out
    _free()
    out, av = FB.fused_hstu_block_train(x, ops, tt, H, 1234, rate)
    torch.cuda.synchronize()
    ref, ref_av = FB.fused_hstu_block_train_plain(x, ops, tt, H, 1234, rate)
    ok1, e1, _ = compare(out, ref, dt)
    # av is 0 on the fully padded row: held as a whole, not per token
    ok2, e2, _ = compare_grad(av, ref_av, dt)
    differs = True
    if rate > 0:
        other, _ = FB.fused_hstu_block_train_plain(x, ops, tt, H, 1235, rate)
        differs = not compare(out, other, dt)[0]
        del other
    del out, av, ref
    _free()
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(dt).cuda()
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, ops, tt, H, 1234, rate)
    torch.cuda.synchronize()
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, ops, tt, H, 1234,
                                         rate)
    ok3, worst, parts = True, (None, 0.0), []
    for name in want:
        okg, eg, limg = compare_grad(got[name], want[name], dt)
        okg &= bool(torch.isfinite(got[name].float()).all())
        ok3 &= okg
        if eg >= worst[1]:
            worst = (name, eg)
        if not okg:
            parts.append(f"{name} {eg:.4g} ({limg})")
    ok = ok0 and ok1 and ok2 and ok3 and differs
    variant = "chunked" if FB.chunked(shp["L"], shp["D"]) else "whole-seq"
    log(f"{variant} {shp} {str(dt)[6:]} p={rate}: inference "
        f"max_abs_err={e0:.6g} ({lim0}); training out {e1:.6g}, av {e2:.6g}"
        + (f", another seed fails the limit: {differs}" if rate > 0 else "")
        + f"; backward largest error {worst[1]:.6g} ({worst[0]})"
        + (f", failing: {'; '.join(parts)}" if parts else "")
        + f"; {time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    del got, want, ref_av, dout, x, ops, tt
    _free()
    return ok


def phase_kernels():
    """Every kernel against its plain version, on seeded inputs with left
    padding and one fully padded row: the whole-sequence variant at L=1024
    (D=64) and L=256 (D=32, H=2); the chunked variant at L = 2048, 4096
    and 16384 (D=64) in f32 and bf16 and at D=128 and D=256 in f32; then
    the chunked variant's bf16 rounding point."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    f32, bf16 = torch.float32, torch.bfloat16

    def shape(B, L, D=64, H=1, F=256):
        return dict(B=B, L=L, D=D, H=H, F=F, NB=128)

    a, b = shape(8, 1024), shape(4, 256, D=32, H=2)
    cases = [(a, f32, 0.0), (a, f32, 0.5), (b, f32, 0.0), (b, f32, 0.5),
             (a, bf16, 0.0), (a, bf16, 0.5),
             (shape(4, 2048), f32, 0.5), (shape(4, 2048), bf16, 0.01),
             (shape(4, 4096), f32, 0.5), (shape(4, 4096), bf16, 0.01),
             (shape(2, 16384), f32, 0.5), (shape(2, 16384), bf16, 0.01),
             (shape(2, 1024, D=128, F=512), f32, 0.5),
             (shape(2, 512, D=256, F=768), f32, 0.5)]
    ok_all = True
    for i, (shp, dt, rate) in enumerate(cases):
        ok_all &= check_kernels(shp, dt, rate, seed=11 + 2 * i)

    # the rounding point: in bf16 the kernel's output agrees with the plain
    # chunked version in more elements than with the plain whole-sequence
    # version (LN2 on the f32 sum), which differs only there
    shp = shape(4, 2048)
    x, ops, tt = block_inputs(**shp, dtype=bf16, seed=30)
    out = FB.fused_hstu_block(x, ops, tt, 1)
    ref = FB.fused_hstu_block_plain(x, ops, tt, 1)
    saved = FB.FB_WHOLESEQ_MAX
    FB.FB_WHOLESEQ_MAX = shp["L"]
    try:
        whole = FB.fused_hstu_block_plain(x, ops, tt, 1)
    finally:
        FB.FB_WHOLESEQ_MAX = saved
    share = (out != ref).float().mean().item()
    share_w = (out != whole).float().mean().item()
    ok = share < share_w
    log(f"chunked rounding point {shp} bf16: output elements differing from "
        f"the plain chunked version {share:.4%}, from the plain "
        f"whole-sequence version {share_w:.4%} {'ok' if ok else 'FAIL'}")
    del x, ops, tt, out, ref, whole
    _free()
    return ok_all and ok


#: (variant suffix of the JSON names, TPU kernel lines of fwd, of bwd)
_REPLACES = {False: ("", "274", "325"),
             True: ("_chunked", "452,468,502", "612,533,573,710")}


def phase_times(s):
    """At a main path's shape, in bf16: each kernel against its plain
    version, then timed (CUDA events) beside it and its bound; returns
    (ok, the kernels' JSON entries without launches)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    bf16, H, p = torch.bfloat16, s["H"], FLAGSHIP_DROPOUT
    suffix, fwd_rows, bwd_rows = _REPLACES[FB.chunked(s["L"], s["D"])]
    x, ops, tt = block_inputs(**s, dtype=bf16, seed=12)
    seed = torch.tensor([99], dtype=torch.int32, device="cuda")
    err = {}
    okx, err["fwd"], _ = compare(FB.fused_hstu_block(x, ops, tt, H),
                                 FB.fused_hstu_block_plain(x, ops, tt, H),
                                 bf16)
    out, _ = FB.fused_hstu_block_train(x, ops, tt, H, seed, p)
    ref, ref_av = FB.fused_hstu_block_train_plain(x, ops, tt, H, seed, p)
    okt, err["fwd_train"], _ = compare(out, ref, bf16)
    del out, ref
    _free()
    dout = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(16), device="cuda").to(bf16)
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, ops, tt, H, seed, p)
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, ops, tt, H, seed, p)
    okb, err["bwd"] = True, 0.0
    for name in want:
        okg, eg, _ = compare_grad(got[name], want[name], bf16)
        okb &= okg
        err["bwd"] = max(err["bwd"], eg)
    del got, want
    _free()
    ok = okx and okt and okb
    log(f"{s} bf16 p={p}: inference max_abs_err {err['fwd']:.6g}, training "
        f"{err['fwd_train']:.6g}, backward largest {err['bwd']:.6g} "
        f"{'ok' if ok else 'FAIL'}")

    t = {"fwd": time_ms(lambda: FB.fused_hstu_block(x, ops, tt, H), 3, 20),
         "fwd_train": time_ms(lambda: FB.fused_hstu_block_train(
             x, ops, tt, H, seed, p), 3, 20),
         "bwd": time_ms(lambda: FB.fused_hstu_block_bwd(
             x, ref_av, dout, ops, tt, H, seed, p), 2, 10)}
    plain = {"fwd": time_ms(lambda: FB.fused_hstu_block_plain(
                 x, ops, tt, H), 1, 5),
             "fwd_train": time_ms(lambda: FB.fused_hstu_block_train_plain(
                 x, ops, tt, H, seed, p), 1, 3),
             "bwd": time_ms(lambda: FB.fused_hstu_block_bwd_plain(
                 x, ref_av, dout, ops, tt, H, seed, p), 1, 3)}
    args = (s["B"], s["L"], s["D"], H, s["F"], 2)
    bounds = {"fwd": fused_block_bound(*args),
              "fwd_train": fused_block_bound(*args, train=True),
              "bwd": fused_block_bwd_bound(*args)}
    entries = []
    for key, src, rows in (("fwd", "fused_block.cu", fwd_rows),
                           ("fwd_train", "fused_block.cu", fwd_rows),
                           ("bwd", "fused_block_bwd.cu", bwd_rows)):
        bound, by, flops, nbytes = bounds[key]
        log(f"{key}{suffix} time at {s}: kernel {t[key]:.4f} ms, plain "
            f"{plain[key]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
            f"{flops / t[key] / 1e9:.1f} TFLOP/s")
        entries.append({"name": f"fused_hstu_block_{key}{suffix}",
                        "route": "cuda", "source": SRC + src,
                        "replaces": f"{TPU}:{rows}", "launches": None,
                        "max_abs_err": err[key], "ms": t[key],
                        "plain_ms": plain[key], "bound_ms": bound,
                        "bound_by": by, "library_ms": None})
    del x, ops, tt, ref_av, dout
    _free()
    return ok, entries


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def phase_training(run):
    """cli.train on the card, one epoch: hstu_flagship at --maxlen 1023, or
    the long path (--maxlen 4095 --batch_size 32 --loader cached)."""
    import numpy as np

    from tencent_recommendation_2025_tpu_torch.cli import train as TRN
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data import synthetic
    from tencent_recommendation_2025_tpu_torch.data.pipeline import \
        train_val_split
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    if run.work.exists():
        shutil.rmtree(run.work)
    data_dir, model_dir, log_dir = run.work / "data", run.work / "model", \
        run.work / "logs"
    t0 = time.perf_counter()
    synthetic.generate(data_dir, mm_emb_ids=("81",), **run.fixture)
    log(f"{run.name}: fixture {run.fixture} generated in "
        f"{time.perf_counter() - t0:.1f} s")

    os.environ["TRAIN_DATA_PATH"] = str(data_dir)
    os.environ["TRAIN_CKPT_PATH"] = str(model_dir)
    os.environ["TRAIN_LOG_PATH"] = str(log_dir)
    FB.fused_hstu_block.launches = 0
    FB.fused_hstu_block_train.launches = 0
    FB.fused_hstu_block_bwd.launches = 0
    timings = {}
    t0 = time.perf_counter()
    state = TRN.main(run.args() + list(run.train_args)
                     + ["--num_epochs", "1"], timings=timings)
    wall = time.perf_counter() - t0
    launches = {"fwd": FB.fused_hstu_block.launches,
                "fwd_train": FB.fused_hstu_block_train.launches,
                "bwd": FB.fused_hstu_block_bwd.launches}

    cfg = PRESETS["hstu_flagship"]()
    data = TencentGRData(data_dir, mm_emb_ids=("81",))
    _, va = train_val_split(len(data.seq), cfg.train.valid_fraction,
                            cfg.train.seed)
    n_valid = -(-len(va) // run.batch_size)
    steps = state.step
    nb = cfg.model.num_blocks
    ok = (launches["fwd_train"] == nb * steps and launches["bwd"] == nb * steps
          and launches["fwd"] == nb * n_valid and steps > 0)
    log(f"{run.name}: training launches: forward (training) "
        f"{launches['fwd_train']}, "
        f"backward {launches['bwd']} (expected {nb} blocks x {steps} steps); "
        f"forward (inference) {launches['fwd']} (expected {nb} x {n_valid} "
        f"validation batches) {'ok' if ok else 'FAIL'}")
    lines = [json.loads(ln) for ln in open(log_dir / "train.log")]
    losses = [ln["loss"] for ln in lines]
    finite = len(losses) == steps and bool(np.isfinite(losses).all())
    ckpt = CK.latest_checkpoint(model_dir)
    ok_ck = ckpt is not None and ckpt.name.startswith(f"global_step{steps}.")
    log(f"{run.name}: train losses ({steps} steps): "
        f"{', '.join(f'{v:.4f}' for v in losses)}"
        f"; finite {finite}; checkpoint {ckpt.name if ckpt else None} "
        f"{'ok' if finite and ok_ck else 'FAIL'}")
    log(f"{run.name}: cli.train wall {wall:.1f} s for {steps} steps of "
        f"{run.batch_size} at L={run.maxlen + 1} (data loading, validation "
        f"and checkpoint included); loader {timings.get('loader')}, cache "
        f"build {timings.get('cache_build_s', float('nan')):.2f} s; last "
        f"logged steps/s {lines[-1]['steps_per_second']:.3f}")
    return ok and finite and ok_ck, launches, data_dir, ckpt, data


def _train_batches(data, n, run, rows=None):
    """The first ``n`` train batches of epoch 1 of ``run`` (streamed; cut to
    ``rows`` rows if given) and its config."""
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.pipeline import (
        TrainLoader, train_val_split)
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg = PRESETS["hstu_flagship"]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, maxlen=run.maxlen),
        train=dataclasses.replace(cfg.train, batch_size=run.batch_size))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    sampler = TrainSampler(data, schema, run.maxlen)
    tr, _ = train_val_split(len(sampler), cfg.train.valid_fraction,
                            cfg.train.seed)
    loader = TrainLoader(sampler, tr, cfg.train.batch_size,
                         seed=cfg.train.seed)
    out = []
    for b in loader.epoch(1):
        if rows is not None:
            b = {k: v[:rows] for k, v in b.items()}
        out.append(b)
        if len(out) == n:
            break
    return cfg, schema, out


def _loss_and_grads(model, cfg, params, batch, tables, device, route=None):
    """Loss and per-leaf gradients of one training forward (dropout off)."""
    import torch

    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    state = TR.init_state(model, cfg, params=params, device=device)
    tabs = TR.device_tables(tables, device)
    saved = ENC.block_route
    if route is not None:
        ENC.block_route = lambda *a: route
    try:
        loss, _ = TR.compute_loss(model, state.params,
                                  TR.put_batch(batch, device), tabs["mm"],
                                  tabs, cfg, train=True)
        loss.backward()
    finally:
        ENC.block_route = saved
    return loss.item(), {p: t.grad.float().cpu()
                         for p, t in TR.param_leaves(state.params)}


def phase_one_step(data, ckpt):
    """One step at full width and depth on the first 16 rows of the first
    train batch, dropout 0: the card (kernels, bf16) against the plain
    versions on the CPU in bf16 and in f32."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, schema, (batch,) = _train_batches(data, 1, FLAGSHIP_RUN, rows=16)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rate=0.0))
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    batch = TR.augment_batch_dedup(batch, cfg, tables, data.itemnum)
    params, _ = CK.load_params(ckpt)

    def model_in(dtype):
        mc = dataclasses.replace(cfg.model, dtype=dtype)
        return (SeqRecModel(cfg=mc, schema=schema,
                            fused=FusedVocab.build(schema),
                            usernum=data.usernum, itemnum=data.itemnum),
                cfg.replace(model=mc))

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    m16, c16 = model_in("bfloat16")
    m32, c32 = model_in("float32")
    card_loss, card = _loss_and_grads(m16, c16, params, batch, tables,
                                      "cuda")
    torch.cuda.synchronize()
    l16, g16 = _loss_and_grads(m16, c16, params, batch, tables, "cpu",
                               route="fused")
    l32, g32 = _loss_and_grads(m32, c32, params, batch, tables, "cpu",
                               route="fused")

    def cos(a, b):
        na, nb = a.norm().item(), b.norm().item()
        if na == 0.0 and nb == 0.0:
            return 1.0
        return float(torch.dot(a.flatten(), b.flatten()) / (na * nb))

    ok_loss = abs(card_loss - l16) <= 1e-3 * abs(l16)
    worst16, worst32, fails = (None, 2.0), (None, 2.0, 0.0), []
    for name in card:
        c16_ = cos(card[name], g16[name])
        c32_ = cos(card[name], g32[name])
        floor = min(0.999, cos(g16[name], g32[name]) - 5e-4)
        if c16_ < worst16[1]:
            worst16 = (name, c16_)
        if c32_ < worst32[1]:
            worst32 = (name, c32_, floor)
        if c16_ < 0.999 or c32_ < floor:
            fails.append(f"{name} ({c16_:.6f}, {c32_:.6f} vs {floor:.6f})")
    ok = ok_loss and not fails and np.isfinite(card_loss)
    log(f"one step, 16 rows at full width and depth ({len(card)} gradient "
        f"leaves, CPU plain versions in {time.perf_counter() - t0:.1f} s): "
        f"loss card {card_loss:.6f}, CPU bf16 {l16:.6f}, CPU f32 {l32:.6f} "
        f"(limit 1e-3 relative to bf16); lowest gradient cosine to CPU bf16 "
        f"{worst16[1]:.6f} ({worst16[0]}, limit 0.999), to CPU f32 "
        f"{worst32[1]:.6f} ({worst32[0]}, limit {worst32[2]:.6f}: 0.999 or "
        f"the CPU bf16 version's own cosine - 5e-4); failing: "
        f"{fails or 'none'} {'ok' if ok else 'FAIL'}")
    return ok


def phase_train_speed(data, ckpt, run):
    """Train examples/s and tokens/s of the step itself (host clock,
    synchronised, after warm-up, on batches already on the card), and where
    one step's time goes (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, schema, raw = _train_batches(data, 4, run)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    batches = [TR.put_batch(TR.augment_batch_dedup(b, cfg, tables,
                                                   data.itemnum), "cuda")
               for b in raw]
    params, _ = CK.load_params(ckpt)
    state = TR.init_state(model, cfg, params=params, device="cuda")
    tabs = TR.device_tables(tables, "cuda")
    step = TR.make_train_step(model, cfg)
    for b in batches[:2]:
        state, m = step(state, b, tabs["mm"], tabs)
    torch.cuda.synchronize()
    n = 6
    t0 = time.perf_counter()
    for i in range(n):
        state, m = step(state, batches[i % len(batches)], tabs["mm"], tabs)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    B, L = cfg.train.batch_size, run.maxlen + 1
    log(f"{run.name}: train step (B={B}, L={L}, bf16, dropout "
        f"{cfg.model.dropout_rate}, tower dedup): {dt * 1e3:.3f} ms, "
        f"{B / dt:.1f} examples/s, {B * L / dt:.0f} tokens/s (host clock, "
        f"synchronised, {n} steps after 2 warm-up)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[0], tabs["mm"], tabs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total / 1e3
    busy = sum(by_name.values())

    def share(names):
        return sum(v for k, v in by_name.items() if any(n in k for n in names))

    fwd, bwd = share(FWD_KERNELS), share(BWD_KERNELS)
    others = ", ".join(f"{k[:60]} {v:.3f}" for k, v in by_name.most_common()
                       if not any(n in k for n in FWD_KERNELS + BWD_KERNELS)
                       )[:900]
    fsplit = ", ".join(f"{n} {share((n,)):.3f}" for n in FWD_KERNELS)
    split = ", ".join(f"{n} {share((n,)):.3f}" for n in BWD_KERNELS)
    log(f"{run.name}: train step profile: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms "
        f"(idle {max(0.0, 1 - busy / wall):.1%}); forward kernels "
        f"{fwd:.3f} ms ({fsplit}), backward kernels {bwd:.3f} ms ({split}); "
        f"other kernels (ms): {others}")
    return B / dt


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------

def phase_serving(data_dir, ckpt, run):
    """cli.infer on the card on the checkpoint ``run`` trained."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.cli import infer as INF
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data import formats
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TestSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import TestLoader
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK

    res_dir = WORK / "result"
    mcfg = dataclasses.replace(PRESETS["hstu_flagship"]().model,
                               maxlen=run.maxlen)
    data = TencentGRData(data_dir, mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=mcfg, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    log(f"flagship D={mcfg.hidden_units} blocks={mcfg.num_blocks} "
        f"H={mcfg.num_heads} L={mcfg.maxlen + 1} dtype={mcfg.dtype}: serving "
        f"the trained checkpoint {ckpt.name}")

    os.environ["EVAL_DATA_PATH"] = str(data_dir)
    os.environ["EVAL_RESULT_PATH"] = str(res_dir)
    os.environ["MODEL_OUTPUT_PATH"] = str(ckpt.parent)
    timings = {}
    FB.fused_hstu_block.launches = 0
    metrics = INF.main(run.args(), timings=timings)
    launches = FB.fused_hstu_block.launches
    nb = timings["n_query_batches"]
    # every test user is a query, in batches of 128
    ok = nb == -(-run.fixture["num_users"] // 128) and \
        launches == mcfg.num_blocks * nb
    log(f"fused_block launches on the serving path: {launches} "
        f"(expected {mcfg.num_blocks} blocks x {nb} query batches) "
        f"{'ok' if ok else 'FAIL'}")

    # first query batch again through the plain version of every kernel on
    # the path, on the CPU: in f32, and in bf16 (the card's rounding points)
    queries = formats.load_fbin(res_dir / "query.fbin")
    corpus = formats.load_fbin(res_dir / "embedding.fbin")
    finite = bool(np.isfinite(queries).all() and np.isfinite(corpus).all())
    shapes_ok = queries.shape == (run.fixture["num_users"],
                                  mcfg.hidden_units) \
        and corpus.shape == (run.fixture["num_items"], mcfg.hidden_units)
    torch.set_num_threads(os.cpu_count() or 1)
    batch, _, n_valid = next(iter(TestLoader(
        TestSampler(data, schema, mcfg.maxlen), 128, num_workers=8)))
    cpu_params, _ = CK.load_params(ckpt)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    n_valid = min(n_valid, run.n_check)
    tb = {k: torch.from_numpy(v[:run.n_check]) for k, v in batch.items()}
    mm = {k: torch.from_numpy(v) for k, v in tables.mm.items()}
    t0 = time.perf_counter()
    ref32 = plain_queries(model, cpu_params, tb, mm, "float32")[:n_valid]
    ref16 = plain_queries(model, cpu_params, tb, mm, "bfloat16")[:n_valid]
    got = queries[:n_valid]
    cos32, cos16 = cosine(got, ref32), cosine(got, ref16)
    # bf16 arithmetic alone (the plain version in bf16) drifts from f32 over
    # 8 blocks, for some queries past 0.999 cosine: there the card is held
    # to that drift plus half the same-arithmetic slack of 1e-3
    floor = cosine(ref16, ref32)
    limit32 = np.minimum(0.999, floor - 5e-4)
    cos_ok = bool((cos32 >= limit32).all() and cos16.min() >= 0.999)
    log(f"{run.name}: first {n_valid} queries (plain versions on the CPU in "
        f"{time.perf_counter() - t0:.1f} s): card bf16 vs CPU bf16 cosine min "
        f"{cos16.min():.6f} (limit 0.999); card bf16 vs CPU f32 cosine min "
        f"{cos32.min():.6f} median {np.median(cos32):.6f} (limit 0.999, or "
        f"the CPU bf16 version's own cosine - 5e-4 where that is lower: "
        f"{int((limit32 < 0.999).sum())} queries, its lowest "
        f"{floor.min():.6f}); max abs diff to f32 "
        f"{np.abs(got - ref32).max():.4g} {'ok' if cos_ok else 'FAIL'}")
    log(f"outputs: queries {queries.shape}, corpus {corpus.shape}, finite="
        f"{finite} {'ok' if finite and shapes_ok else 'FAIL'}")
    profile_predict(model, CK.load_params(ckpt, model, device="cuda")[0],
                    {k: torch.from_numpy(v).cuda() for k, v in batch.items()},
                    {k: v.cuda() for k, v in mm.items()})
    serving = {
        "queries_per_s": timings["n_queries"] / timings["predict_s"],
        "corpus_items_per_s": timings["n_items"] / timings["encode_items_s"],
        "topk_ms": timings["topk_s"] * 1e3,
        "n_queries": timings["n_queries"], "n_items": timings["n_items"],
        "hr10": metrics["hr"], "ndcg10": metrics["ndcg"]}
    log(f"{run.name}: serving at L={run.maxlen + 1} " + json.dumps(serving))
    return ok and cos_ok and finite and shapes_ok, launches


def profile_predict(model, params, batch, mm):
    """Where one predict batch's time goes: device time by kernel name
    (torch.profiler) against the synchronised host clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.predict(params, batch, mm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(params, batch, mm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.device_time_total / 1e3
    busy = sum(by_name.values())
    fused = sum(v for k, v in by_name.items()
                if any(n in k for n in FWD_KERNELS))
    others = ", ".join(f"{k[:60]} {v:.3f}" for k, v in by_name.most_common()
                       if not any(n in k for n in FWD_KERNELS))[:600]
    log(f"predict profile (one batch of {batch['seq'].shape[0]}): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms (idle "
        f"{max(0.0, 1 - busy / wall_ms):.1%}); fused block kernels "
        f"{fused:.3f} ms; other kernels (ms): {others}")


def plain_queries(model, params, batch, mm, dtype):
    """Last-position queries of one CPU batch through the encoder's fused
    route, i.e. the plain version of the fused block kernel, in ``dtype``."""
    import torch

    from tencent_recommendation_2025_tpu_torch.models import embedding as E
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    with torch.no_grad():
        fe = E.fuse_sequence(params, batch, mm, model.fused, model.schema,
                             cfg)
        out = ENC.encode(params, fe, batch["seq"], batch["token_type"],
                         params["pos_emb"], cfg, route="fused")
    return out[:, -1].float().numpy()


def cosine(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from tencent_recommendation_2025_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    report = kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sorted(report)) or 'already built'})")
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(regs))

    oks = {}
    t0 = time.perf_counter()
    oks["kernels"] = phase_kernels()
    oks["times"], entries = phase_times(FLAGSHIP)
    oks["times_chunked"], chunked = phase_times(LONG)
    entries += chunked
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    # the JSON entries in order: fwd, fwd_train, bwd of each variant
    for run, found in ((FLAGSHIP_RUN, entries[:3]), (LONG_RUN, entries[3:])):
        t0 = time.perf_counter()
        oks[f"{run.name}_train"], tl, data_dir, ckpt, data = \
            phase_training(run)
        if run is FLAGSHIP_RUN:
            oks["one_step"] = phase_one_step(data, ckpt)
        phase_train_speed(data, ckpt, run)
        log(f"{run.name} training phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        oks[f"{run.name}_serve"], served = phase_serving(data_dir, ckpt, run)
        log(f"{run.name} serving phase: {time.perf_counter() - t0:.1f} s")
        for entry, n in zip(found, (served, tl["fwd_train"], tl["bwd"])):
            entry["launches"] = n
    log(card)
    log(json.dumps({"kernels": entries}))
    failed = [k for k, v in oks.items() if not v]
    if failed:
        log(f"chip_smoke: FAILED ({', '.join(failed)})")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
