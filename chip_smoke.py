#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device   — require CUDA; print the card's name and power limit
               (nvidia-smi --query-gpu=name,power.limit);
2. build    — compile every kernel under tencent_recommendation_2025_tpu_torch/
               csrc/ from the checkout (nvcc, sm_90a), print the seconds;
3. kernels  — each kernel against its plain PyTorch version on the card, on
               seeded inputs with left padding and one fully padded row, at
               the stated tolerances; then its time at the main path's shape
               (CUDA events) beside the plain version's and its bound;
4. serving  — a seeded synthetic fixture (1024 users, 5000 items, sequences
               of 256..1000 events), a seeded flagship model written as a
               checkpoint, and the port's cli.infer main with
               ``--preset hstu_flagship --maxlen 1023`` on the card; checks
               the fused-block launch count, recomputes the first query
               batch with the plain versions on the CPU in bf16 and in f32
               and holds the card's bf16 queries to both (per-query cosine);
               prints serving throughput and HR@10/NDCG@10 (random weights:
               printed, not judged);
5. report   — one JSON line per kernel list, then the last line
               ``{"ok": true, "device": {...}}``.

Scratch data goes to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

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
# the serving run: synthetic fixture and window (maxlen 1023 gives L=1024,
# the kernel's shape); the model is the hstu_flagship preset as it stands
FIXTURE = dict(num_users=1024, num_items=5000, min_seq=256, max_seq=1000,
               seed=21)
MAXLEN = 1023


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


def fused_block_bound(B, L, D, H, F, elem_bytes, peak_flops):
    """Least time (ms) of one fused block forward: the larger of its matmul
    operations over the peak rate and its bytes (inputs once, output once)
    over the memory rate. Causal: q.k^T and a.v each cost L(L+1)/2 key
    pairs per query row."""
    flops = (2 * B * L * D * 4 * D           # projection
             + 2 * B * D * L * (L + 1)        # q.k^T and a.v, causal
             + 2 * B * L * D * D              # Wo
             + 2 * B * L * D * 2 * F          # W13
             + 2 * B * L * F * D)             # W2
    weights = (D * 4 * D + D * D + D * 2 * F + F * D) * elem_bytes
    small = (6 * D + 4 * D + D + H * 128) * 4
    nbytes = 2 * B * L * D * elem_bytes + B * L * 4 + weights + small
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_kernels():
    import torch

    from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("a", dict(B=8, L=1024, D=64, H=1, F=256, NB=128), f32),
             ("a", dict(B=8, L=1024, D=64, H=1, F=256, NB=128), bf16),
             ("b", dict(B=4, L=256, D=32, H=2, F=256, NB=128), f32)]
    ok_all = True
    for name, shp, dt in cases:
        x, ops, tt = block_inputs(**shp, dtype=dt, seed=11)
        out = FB.fused_hstu_block(x, ops, tt, shp["H"])
        torch.cuda.synchronize()
        ref = FB.fused_hstu_block_plain(x, ops, tt, shp["H"])
        ok, err, lim = compare(out, ref, dt)
        finite = bool(torch.isfinite(out.float()).all())
        log(f"fused_block case ({name}) {shp} {str(dt)[6:]}: "
            f"max_abs_err={err:.6g} limit {lim} finite={finite} "
            f"{'ok' if ok and finite else 'FAIL'}")
        ok_all &= ok and finite

    # time at the main path's shape, in the product dtype
    s = FLAGSHIP
    x, ops, tt = block_inputs(**s, dtype=bf16, seed=12)
    out = FB.fused_hstu_block(x, ops, tt, s["H"])
    ref = FB.fused_hstu_block_plain(x, ops, tt, s["H"])
    ok, err, lim = compare(out, ref, bf16)
    log(f"fused_block flagship {s} bf16: max_abs_err={err:.6g} limit {lim} "
        f"{'ok' if ok else 'FAIL'}")
    ok_all &= ok
    ms = time_ms(lambda: FB.fused_hstu_block(x, ops, tt, s["H"]), 3, 20)
    plain_ms = time_ms(lambda: FB.fused_hstu_block_plain(x, ops, tt, s["H"]),
                       1, 5)
    bound, by, flops, nbytes = fused_block_bound(
        s["B"], s["L"], s["D"], s["H"], s["F"], 2, PEAK_BF16_FLOPS)
    log(f"fused_block flagship time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({by}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB); kernel at {flops / ms / 1e9:.1f} TFLOP/s")
    entry = {"name": "fused_hstu_block_fwd", "route": "cuda",
             "source": "tencent_recommendation_2025_tpu_torch/csrc/"
                       "fused_block.cu",
             "replaces": "tencent_recommendation_2025_tpu/ops/fused_block.py"
                         ":274",
             "launches": None, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None}
    return ok_all, [entry]


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

def phase_serving():
    """cli.infer on the card: hstu_flagship at --maxlen 1023 on FIXTURE."""
    import numpy as np
    import torch

    from tencent_recommendation_2025_tpu_torch.cli import infer as INF
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data import formats, synthetic
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

    if WORK.exists():
        shutil.rmtree(WORK)
    data_dir, model_dir, res_dir = WORK / "data", WORK / "model", \
        WORK / "result"
    t0 = time.perf_counter()
    synthetic.generate(data_dir, mm_emb_ids=("81",), **FIXTURE)
    log(f"fixture generated in {time.perf_counter() - t0:.1f} s")

    mcfg = dataclasses.replace(PRESETS["hstu_flagship"]().model,
                               maxlen=MAXLEN)
    data = TencentGRData(data_dir, mm_emb_ids=("81",), split="test")
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=mcfg, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    params = model.init(torch.Generator().manual_seed(21))
    ckpt = CK.save_params(model_dir, params, global_step=0,
                          model_config=mcfg)
    log(f"flagship D={mcfg.hidden_units} blocks={mcfg.num_blocks} "
        f"H={mcfg.num_heads} L={mcfg.maxlen + 1} dtype={mcfg.dtype}: "
        f"{sum(t.numel() for t in _leaves(params))} parameters -> {ckpt.name}")

    os.environ["EVAL_DATA_PATH"] = str(data_dir)
    os.environ["EVAL_RESULT_PATH"] = str(res_dir)
    os.environ["MODEL_OUTPUT_PATH"] = str(model_dir)
    timings = {}
    FB.fused_hstu_block.launches = 0
    metrics = INF.main(["--preset", "hstu_flagship", "--maxlen", str(MAXLEN)],
                       timings=timings)
    launches = FB.fused_hstu_block.launches
    nb = timings["n_query_batches"]
    # every test user is a query: 1024 users in batches of 128
    ok = nb == -(-FIXTURE["num_users"] // 128) and \
        launches == mcfg.num_blocks * nb
    log(f"fused_block launches on the serving path: {launches} "
        f"(expected {mcfg.num_blocks} blocks x {nb} query batches) "
        f"{'ok' if ok else 'FAIL'}")

    # first query batch again through the plain version of every kernel on
    # the path, on the CPU: in f32, and in bf16 (the card's rounding points)
    queries = formats.load_fbin(res_dir / "query.fbin")
    corpus = formats.load_fbin(res_dir / "embedding.fbin")
    finite = bool(np.isfinite(queries).all() and np.isfinite(corpus).all())
    shapes_ok = queries.shape == (FIXTURE["num_users"], mcfg.hidden_units) \
        and corpus.shape == (FIXTURE["num_items"], mcfg.hidden_units)
    torch.set_num_threads(os.cpu_count() or 1)
    batch, _, n_valid = next(iter(TestLoader(
        TestSampler(data, schema, mcfg.maxlen), 128, num_workers=8)))
    cpu_params, _ = CK.load_params(ckpt)
    tables = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                               data.mm_emb_dict, data.indexer_i_rev)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
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
    log(f"first query batch ({n_valid} queries, plain versions on the CPU in "
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
                    {k: v.cuda() for k, v in tb.items()},
                    {k: v.cuda() for k, v in mm.items()})
    serving = {
        "queries_per_s": timings["n_queries"] / timings["predict_s"],
        "corpus_items_per_s": timings["n_items"] / timings["encode_items_s"],
        "topk_ms": timings["topk_s"] * 1e3,
        "n_queries": timings["n_queries"], "n_items": timings["n_items"],
        "hr10": metrics["hr"], "ndcg10": metrics["ndcg"]}
    log("serving " + json.dumps(serving))
    return ok and cos_ok and finite and shapes_ok, launches


def profile_predict(model, params, batch, mm):
    """Where one predict batch's time goes: device time by kernel name
    (torch.profiler) against the synchronised host clock."""
    import collections

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
                if "proj_kernel" in k or "attn_ffn_kernel" in k)
    others = ", ".join(f"{k[:60]} {v:.3f}" for k, v in by_name.most_common()
                       if "proj_kernel" not in k and "attn_ffn_kernel" not in k
                       )[:600]
    log(f"predict profile (one batch of {batch['seq'].shape[0]}): wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms (idle "
        f"{max(0.0, 1 - busy / wall_ms):.1%}); fused block kernels "
        f"{fused:.3f} ms; other kernels (ms): {others}")


def plain_queries(model, params, batch, mm, dtype):
    """Last-position queries of one CPU batch through the encoder's fused
    route, i.e. the plain version of the fused block kernel, in ``dtype``."""
    from tencent_recommendation_2025_tpu_torch.models import embedding as E
    from tencent_recommendation_2025_tpu_torch.models import encoder as ENC

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    fe = E.fuse_sequence(params, batch, mm, model.fused, model.schema, cfg)
    out = ENC.encode(params, fe, batch["seq"], batch["token_type"],
                     params["pos_emb"], cfg, route="fused")
    return out[:, -1].float().numpy()


def cosine(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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

    ok_k, entries = phase_kernels()
    ok_s, launches = phase_serving()
    entries[0]["launches"] = launches
    log(card)
    log(json.dumps({"kernels": entries}))
    if not (ok_k and ok_s):
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
