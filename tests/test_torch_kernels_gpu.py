"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    PYTHONPATH=. python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_kernels_gpu.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu_torch.config import ModelConfig
from tencent_recommendation_2025_tpu_torch.models import encoder as ENC
from tencent_recommendation_2025_tpu_torch.ops import fused_block as FB

torch.set_num_threads(2)


def _block(B, L, D, H, dtype, seed):
    """One block's seeded kernel operands (LN, biases and rel-pos bias off
    their init) and inputs: row 0 left-padded, the last row fully
    padded."""
    cfg = ModelConfig(hidden_units=D, num_heads=H, block_type="hstu",
                      ffn_type="swiglu", reference_init=False)
    rng = np.random.default_rng(seed)
    bp = ENC.init_block_params(torch.Generator().manual_seed(seed), cfg)

    def perturb(t, key):
        if isinstance(t, dict):
            return {k: perturb(v, k) for k, v in t.items()}
        if key in ("b", "bias", "scale", "rab"):
            t = t + torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.1)
        return t.cuda()

    x = torch.from_numpy(
        (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32))
    tt = np.ones((B, L), np.int32)
    tt[0, :L // 3 + 5] = 0
    tt[-1] = 0
    return (FB.block_operands(perturb(bp, ""), dtype), x.to(dtype).cuda(),
            torch.from_numpy(tt).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,D,H", [(2, 256, 32, 2), (2, 512, 64, 1)])
def test_fused_block_kernel_matches_plain_on_card(B, L, D, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    torch.backends.cuda.matmul.allow_tf32 = False
    bp, x, tt = _block(B, L, D, H, torch.float32, seed=1)
    before = FB.fused_hstu_block.launches
    out = FB.fused_hstu_block(x, bp, tt, H)
    torch.cuda.synchronize()
    assert FB.fused_hstu_block.launches == before + 1
    ref = FB.fused_hstu_block_plain(x, bp, tt, H)
    # f32 operands, sums of up to L terms taken in another order
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(out, ref, what):
    """f32: rtol 2e-4 and atol 2e-5 * max(1, max|ref|); sums of up to B*L
    terms are taken in another order on the card."""
    ref = ref.float()
    atol = 2e-5 * max(1.0, ref.abs().max().item())
    torch.testing.assert_close(out.float(), ref, rtol=2e-4, atol=atol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B,L,D,H", [(2, 256, 32, 2), (2, 512, 64, 1)])
def test_train_forward_kernel_matches_plain_on_card(B, L, D, H, rate):
    _cuda_or_skip()
    bp, x, tt = _block(B, L, D, H, torch.float32, seed=2)
    before = FB.fused_hstu_block_train.launches
    out, av = FB.fused_hstu_block_train(x, bp, tt, H, 1234, rate)
    torch.cuda.synchronize()
    assert FB.fused_hstu_block_train.launches == before + 1
    ref, ref_av = FB.fused_hstu_block_train_plain(x, bp, tt, H, 1234, rate)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(av, ref_av, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B,L,D,H", [(2, 256, 32, 2), (2, 512, 64, 1)])
def test_backward_kernel_matches_plain_on_card(B, L, D, H, rate):
    _cuda_or_skip()
    bp, x, tt = _block(B, L, D, H, torch.float32, seed=3)
    _, av = FB.fused_hstu_block_train_plain(x, bp, tt, H, 77, rate)
    dout = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(x.shape)).astype(np.float32)).cuda()
    before = FB.fused_hstu_block_bwd.launches
    got = FB.fused_hstu_block_bwd(x, av, dout, bp, tt, H, 77, rate)
    torch.cuda.synchronize()
    assert FB.fused_hstu_block_bwd.launches == before + 1
    ref = FB.fused_hstu_block_bwd_plain(x, av, dout, bp, tt, H, 77, rate)
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name], ref[name], name)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_chunked_variant_kernels_match_plain_on_card(rate):
    """L=2048 > wholeseq_max_l(64): the kernels' chunked variant (LN2 reads
    the rounded av) against the plain versions' chunked variant: inference
    and training forward (out and av) and the backward."""
    _cuda_or_skip()
    B, L, D, H = 2, 2048, 64, 1
    assert FB.chunked(L, D)
    bp, x, tt = _block(B, L, D, H, torch.float32, seed=5)
    out = FB.fused_hstu_block(x, bp, tt, H)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, FB.fused_hstu_block_plain(x, bp, tt, H),
                               rtol=1e-4, atol=1e-4)
    out, av = FB.fused_hstu_block_train(x, bp, tt, H, 4321, rate)
    torch.cuda.synchronize()
    ref, ref_av = FB.fused_hstu_block_train_plain(x, bp, tt, H, 4321, rate)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(av, ref_av, rtol=1e-4, atol=1e-4)
    dout = torch.from_numpy(np.random.default_rng(6).standard_normal(
        tuple(x.shape)).astype(np.float32)).cuda()
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 4321, rate)
    torch.cuda.synchronize()
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, bp, tt, H, 4321,
                                         rate)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)


@pytest.mark.gpu
def test_chunked_variant_rounds_av_before_ln2_on_card():
    """In bf16 the kernel's chunked variant writes the av its LN2 read: the
    training forward's av is bf16 and the output agrees with the plain
    chunked version more closely than with the whole-sequence one."""
    _cuda_or_skip()
    B, L, D, H = 2, 2048, 64, 1
    bp, x, tt = _block(B, L, D, H, torch.bfloat16, seed=7)
    out, av = FB.fused_hstu_block_train(x, bp, tt, H, 0, 0.0)
    torch.cuda.synchronize()
    ref, _ = FB.fused_hstu_block_train_plain(x, bp, tt, H, 0, 0.0)
    saved = FB.FB_WHOLESEQ_MAX
    FB.FB_WHOLESEQ_MAX = L
    try:
        whole, _ = FB.fused_hstu_block_train_plain(x, bp, tt, H, 0, 0.0)
    finally:
        FB.FB_WHOLESEQ_MAX = saved
    assert av.dtype == torch.bfloat16
    share = (out != ref).float().mean().item()
    share_whole = (out != whole).float().mean().item()
    assert share < share_whole, (share, share_whole)


def _attention(B, L, D, H, dtype, seed, NB=128):
    """Seeded q, k, v, dout [B, L, D], rab [H, NB] and the key-valid mask
    on the card: row 0 left-padded, the last row fully padded."""
    rng = np.random.default_rng(seed)

    def t(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).cuda()

    q, k, v, dout = (t((B, L, D)).to(dtype) for _ in range(4))
    valid = np.ones((B, L), bool)
    valid[0, :L // 3 + 5] = False
    valid[-1] = False
    return q, k, v, dout, torch.from_numpy(valid).cuda(), t((H, NB), 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("L,H", [(256, 4), (1024, 1)])
def test_flash_attention_kernels_match_plain_on_card(L, H):
    """Forward and backward kernels in f32 against their plain versions;
    fully masked rows and padded keys give exactly 0."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA

    q, k, v, dout, valid, _ = _attention(3, L, 64, H, torch.float32, 8)
    before = (FA.flash_mha_fwd.launches, FA.flash_mha_bwd.launches)
    out, stats = FA.flash_mha_fwd(q, k, v, valid, H, return_stats=True)
    grads = FA.flash_mha_bwd(q, k, v, dout, valid, H, stats)
    torch.cuda.synchronize()
    assert (FA.flash_mha_fwd.launches,
            FA.flash_mha_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, FA.flash_mha_fwd_plain(q, k, v, valid, H),
                               rtol=1e-4, atol=1e-4)
    for name, g, r in zip(("dq", "dk", "dv"), grads,
                          FA.flash_mha_bwd_plain(q, k, v, dout, valid, H)):
        _close(g, r, name)
        assert not g[-1].any() and not g[0, :L // 3 + 5].any(), name
    assert not out[-1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("L,H,NB", [(256, 4, 128), (1024, 1, 300)])
def test_hstu_attention_kernels_match_plain_on_card(L, H, NB):
    """Forward and backward kernels (dq, dk, dv and the rel-pos gradient)
    in f32 against their plain versions."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    q, k, v, dout, valid, rab = _attention(3, L, 64, H, torch.float32, 9, NB)
    before = (HA.hstu_attention_fwd.launches, HA.hstu_attention_bwd.launches)
    out = HA.hstu_attention_fwd(q, k, v, valid, rab, L, H)
    grads = HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L, H)
    torch.cuda.synchronize()
    assert (HA.hstu_attention_fwd.launches,
            HA.hstu_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        out, HA.hstu_attention_fwd_plain(q, k, v, valid, rab, L, H),
        rtol=1e-4, atol=1e-4)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads,
                          HA.hstu_attention_bwd_plain(q, k, v, dout, valid,
                                                      rab, L, H)):
        _close(g, r, name)


@pytest.mark.gpu
@pytest.mark.parametrize("L,H,NB", [(2048, 4, 128), (2048, 1, 1000)])
def test_chunked_hstu_attention_kernels_match_plain_on_card(L, H, NB):
    """Past ``_use_long`` (the JAX package's chunked kernels, here at its
    256 tile, 1000 buckets too) the kernels launch under the chunked
    wrappers' counters and match their plain versions in f32."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    assert HA._use_long(L, 64) and HA._tile_blk(L, H, NB, 64) == 256
    q, k, v, dout, valid, rab = _attention(2, L, 64, H, torch.float32, 14, NB)
    counters = (HA.hstu_attention_fwd, HA.hstu_attention_bwd,
                HA.hstu_attention_chunk_fwd, HA.hstu_attention_chunk_bwd)
    before = [c.launches for c in counters]
    out = HA.hstu_attention_fwd(q, k, v, valid, rab, L, H)
    grads = HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L, H)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 1, 1]
    torch.testing.assert_close(
        out, HA.hstu_attention_fwd_plain(q, k, v, valid, rab, L, H),
        rtol=1e-4, atol=1e-4)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads,
                          HA.hstu_attention_bwd_plain(q, k, v, dout, valid,
                                                      rab, L, H)):
        _close(g, r, name)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["flash", "hstu"])
@pytest.mark.parametrize("D,H", [(32, 4), (128, 1)])
def test_attention_kernels_at_head_dims_on_card(kind, D, H):
    """hd 8 and hd 128 against the plain versions, f32 and bf16 (flash
    MHA: f32 on the first kernels, FMA loops at hd 8 and cut tiles at 128;
    bf16 on the wgmma kernels, hd 8 padded to 16 columns)."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    L = 256
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, dout, valid, rab = _attention(2, L, D, H, dt, 15)
        if kind == "flash":
            out, stats = FA.flash_mha_fwd(q, k, v, valid, H,
                                          return_stats=True)
            got = (out, *FA.flash_mha_bwd(q, k, v, dout, valid, H, stats))
            want = (FA.flash_mha_fwd_plain(q, k, v, valid, H),
                    *FA.flash_mha_bwd_plain(q, k, v, dout, valid, H))
        else:
            got = (HA.hstu_attention_fwd(q, k, v, valid, rab, L, H),
                   *HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L, H))
            want = (HA.hstu_attention_fwd_plain(q, k, v, valid, rab, L, H),
                    *HA.hstu_attention_bwd_plain(q, k, v, dout, valid, rab,
                                                 L, H))
        torch.cuda.synchronize()
        for name, g, r in zip(("out", "dq", "dk", "dv", "drab"), got, want):
            if dt == torch.float32:
                _close(g, r, name)
            else:   # one bf16 step of the largest value, cosine 0.999
                g, r = g.float().flatten(), r.float().flatten()
                assert (g - r).abs().max() <= 3e-2 * max(1.0, r.abs().max())
                assert torch.nn.functional.cosine_similarity(g, r, 0) > 0.999


def _bf16_close(got, ref, what):
    """One bf16 step of the largest value, cosine 0.999."""
    g, r = got.float().flatten(), ref.float().flatten()
    assert (g - r).abs().max() <= 3e-2 * max(1.0, r.abs().max()), what
    assert torch.nn.functional.cosine_similarity(g, r, 0) >= 0.999, what


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D,H", [(1024, 64, 4), (512, 96, 4),
                                   (256, 256, 1), (384, 64, 1), (256, 36, 4)])
def test_flash_attention_paths_on_card(L, D, H, dtype):
    """Every path of the flash kernels: hd 16 at L=1024, hd 24 (a head
    padded to 32 columns), hd 256 (the first kernels' bf16 path), L=384
    (six tiles) and hd 9 (odd: copies through registers, element stores),
    f32 and bf16, with left padding and a fully padded row. Outputs and gradients match the plain versions (f32 rtol 1e-4 /
    2e-4; bf16 as _bf16_close), fully masked tokens are exactly 0, and the
    kernel's row stats match the plain forward's (rtol 1e-4; rows with no
    visible key exactly finfo(f32).min and 0)."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA

    q, k, v, dout, valid, _ = _attention(4, L, D, H, dtype, 16)
    out, stats = FA.flash_mha_fwd(q, k, v, valid, H, return_stats=True)
    grads = FA.flash_mha_bwd(q, k, v, dout, valid, H, stats)
    torch.cuda.synchronize()
    ref, ref_stats = FA.flash_mha_fwd_plain(q, k, v, valid, H,
                                            return_stats=True)
    want = FA.flash_mha_bwd_plain(q, k, v, dout, valid, H, ref_stats)
    pad = L // 3 + 5
    for name, g, r in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (ref, *want)):
        if dtype == torch.float32:
            _close(g, r, name)
        else:
            _bf16_close(g, r, name)
        assert not g[-1].any() and not g[0, :pad].any(), name
    dead = ref_stats[1] == 0
    assert (stats[1][dead] == 0).all()
    assert (stats[0][dead] == torch.finfo(torch.float32).min).all()
    torch.testing.assert_close(stats[:, ~dead], ref_stats[:, ~dead],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_backward_needs_the_forward_stats_on_card():
    """On CUDA tensors the backward raises without the forward's stats, or
    with stats of another shape, before a launch."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA

    q, k, v, dout, valid, _ = _attention(2, 256, 64, 4, torch.bfloat16, 17)
    _, stats = FA.flash_mha_fwd(q, k, v, valid, 4, return_stats=True)
    before = FA.flash_mha_bwd.launches
    with pytest.raises(ValueError, match="stats"):
        FA.flash_mha_bwd(q, k, v, dout, valid, 4)
    with pytest.raises(ValueError, match="stats"):
        FA.flash_mha_bwd(q, k, v, dout, valid, 4, stats[:, :1])
    assert FA.flash_mha_bwd.launches == before


@pytest.mark.gpu
def test_attention_wrappers_raise_instead_of_falling_back_on_card():
    """On CUDA tensors a head of 512 launches the HSTU kernels' first
    design, equal to its plain version (f32: forward and gradients within
    1e-4 of max(1, max|plain|)); a flash head past 256 raises
    NotImplementedError, and D not a multiple of H and fp16 raise, before
    a launch."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import flash_attention as FA
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    q, k, v, dout, valid, rab = _attention(2, 256, 512, 1, torch.float32, 10)
    counters = (HA.hstu_attention_chunk_fwd, HA.hstu_attention_chunk_bwd)
    before = [c.launches for c in counters]
    got = (HA.hstu_attention_fwd(q, k, v, valid, rab, 256, 1),
           *HA.hstu_attention_bwd(q, k, v, dout, valid, rab, 256, 1))
    # hd 512 at L=256 is a chunked shape (_use_long)
    assert [c.launches for c in counters] == [n + 1 for n in before]
    cpu = [t.cpu() for t in (q, k, v, dout, valid, rab)]
    want = (HA.hstu_attention_fwd_plain(*cpu[:3], cpu[4], cpu[5], 256, 1),
            *HA.hstu_attention_bwd_plain(*cpu, 256, 1))
    for name, g, w in zip(("out", "dq", "dk", "dv", "drab"), got, want):
        err = (g.cpu().float() - w.float()).abs().max().item()
        assert err <= 1e-4 * max(1.0, w.abs().max().item()), (name, err)
    wide = q.new_zeros((2, 256, 264))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        FA.flash_mha_fwd(wide, wide, wide, valid, 1)
    q, k, v, _, valid, rab = _attention(2, 256, 64, 3, torch.float32, 11)
    with pytest.raises(ValueError, match="D % H"):
        FA.flash_mha_fwd(q, k, v, valid, 3)
    half = q.half()
    with pytest.raises(ValueError, match="bf16 or f32"):
        HA.hstu_attention_fwd(half, half, half, valid, rab, 256, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_kernels_match_plain_on_card(dtype):
    """The group scatter writes in place (same buffer, untouched groups
    bitwise unchanged) and equals its plain version bitwise; the group
    gather equals its plain version on the real groups."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    rng = np.random.default_rng(12)
    nG, W, K, n_real = 4096, 1024, 3072, 2500
    table = torch.randn((nG, W), generator=torch.Generator().manual_seed(0)
                        ).to(dtype).cuda()
    groups = np.full((K,), nG, np.int32)
    groups[:n_real] = rng.choice(nG, size=n_real, replace=False)
    g = torch.from_numpy(groups).cuda()
    arranged = torch.randn((K, W), generator=torch.Generator().manual_seed(1)
                           ).to(dtype).cuda()
    before = table.clone()
    ref = ST.group_scatter_plain(table.clone(), g, arranged)
    n = ST.group_scatter.launches
    out = ST.group_scatter(table, g, arranged)
    torch.cuda.synchronize()
    assert ST.group_scatter.launches == n + 1
    assert out.data_ptr() == table.data_ptr() and torch.equal(table, ref)
    untouched = torch.ones(nG, dtype=torch.bool, device="cuda")
    untouched[g[:n_real].long()] = False
    assert torch.equal(table[untouched], before[untouched])
    n = ST.group_gather.launches
    got = ST.group_gather(table, g)
    torch.cuda.synchronize()
    assert ST.group_gather.launches == n + 1
    assert torch.equal(got[:n_real], ST.group_gather_plain(table, g)[:n_real])


@pytest.mark.gpu
def test_group_scatter_apply_launches_kernel_per_chunk_on_card(monkeypatch):
    """On CUDA tensors the packed write-back launches the kernel once per
    chunk and equals its CPU run."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    monkeypatch.setattr(ST, "_SCATTER_CHUNK_GROUPS", 1024)
    rng = np.random.default_rng(13)
    V, D = 64 * 512, 64
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32))
    uids = np.full((1536,), V, np.int32)
    uids[:1500] = np.sort(rng.choice(V, size=1500, replace=False))
    vals = torch.from_numpy(rng.standard_normal((1536, D)).astype(np.float32))
    plan = {k: torch.from_numpy(v)
            for k, v in ST.host_group_plan(uids, V, 16).items()}
    want = ST.group_scatter_apply(table.clone(), vals, plan)
    n = ST.group_scatter.launches
    got = ST.group_scatter_apply(table.cuda(), vals.cuda(),
                                 {k: v.cuda() for k, v in plan.items()})
    torch.cuda.synchronize()
    assert ST.group_scatter.launches == n + 2
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_scatter_on_row_blocks_matches_plain_on_card(dtype):
    """A table row-sharded over 4 shards writes each shard's touched groups
    into its row block, ``group_view(table[lo:hi], R)``, a view at a row
    offset: per block the kernel equals its plain version bitwise and the
    rows outside the block stay as they were; with every block written,
    the whole table equals the plain writes' (the sentinel, the block's
    group count, skipped)."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    S, D = 4, 64
    R = ST.scatter_group_rows(D)
    Vp = ST._PAD_ROWS * 40                  # a padded table: 10240 rows
    rps = Vp // S
    rng = np.random.default_rng(14)
    table = torch.randn((Vp, D), generator=torch.Generator().manual_seed(2)
                        ).to(dtype).cuda()
    ref = table.clone()
    for s in range(S):
        lo, hi = s * rps, (s + 1) * rps
        nGl, K, n_real = rps // R, 128, 100
        groups = np.full((K,), nGl, np.int32)
        groups[:n_real] = np.sort(rng.choice(nGl, size=n_real,
                                             replace=False))
        g = torch.from_numpy(groups).cuda()
        arranged = torch.randn(
            (K, R * D), generator=torch.Generator().manual_seed(10 + s)
        ).to(dtype).cuda()
        before = table.clone()
        block = ST.group_view(table[lo:hi], R)
        assert block.data_ptr() % 16 == 0 and block.is_contiguous()
        want = ST.group_scatter_plain(ST.group_view(ref[lo:hi], R), g,
                                      arranged)
        n = ST.group_scatter.launches
        out = ST.group_scatter(block, g, arranged)
        torch.cuda.synchronize()
        assert ST.group_scatter.launches == n + 1
        assert out.data_ptr() == table[lo:hi].data_ptr()
        assert torch.equal(block, want)
        outside = torch.ones(Vp, dtype=torch.bool, device="cuda")
        outside[lo:hi] = False
        assert torch.equal(table[outside], before[outside])
    assert torch.equal(table, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 256, -256, 768])
@pytest.mark.parametrize("D,H", [(64, 1), (64, 4), (32, 4)])
def test_ring_pair_kernels_match_plain_on_card(D, H, off):
    """Rows 10-12: the pair forward, dq (with drab) and dk/dv kernels of
    csrc/ring_pair.cu, in f32, at every offset kind (the same shard, a past
    one, a future one: no launch, a far past one); hd 8 takes the FMA
    products."""
    _cuda_or_skip()
    rng = np.random.default_rng(D + H + off + 1000)
    B, L = 2, 256

    def t(shape, s=0.5):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32)).cuda()

    q, k, v, dav = t((B, L, D)), t((B, L, D)), t((B, L, D)), t((B, L, D), 1)
    rab = t((H, 128), 0.1)
    valid = torch.ones((B, L), dtype=torch.int32, device="cuda")
    valid[0, :37] = 0
    counts = [fn.launches for fn in (FB.ring_pair_fwd, FB.ring_pair_dq,
                                     FB.ring_pair_dkdv)]
    out = FB.ring_pair_fwd(q, k, v, valid, rab, off, H)
    dq, drab = FB.ring_pair_dq(q, k, v, dav, valid, rab, off, H)
    dk, dv = FB.ring_pair_dkdv(q, k, v, dav, valid, rab, off, H)
    torch.cuda.synchronize()
    launched = off + L > 0
    assert [fn.launches for fn in (FB.ring_pair_fwd, FB.ring_pair_dq,
                                   FB.ring_pair_dkdv)] == \
        [c + launched for c in counts]
    ref = FB.ring_pair_fwd_plain(q, k, v, valid, rab, off, H)
    rdq, rdrab = FB.ring_pair_dq_plain(q, k, v, dav, valid, rab, off, H)
    rdk, rdv = FB.ring_pair_dkdv_plain(q, k, v, dav, valid, rab, off, H)
    for got, want, what in ((out, ref, "av"), (dq, rdq, "dq"),
                            (drab, rdrab, "drab"), (dk, rdk, "dk"),
                            (dv, rdv, "dv")):
        _close(got, want, what)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_ring_stage_kernels_match_plain_on_card(rate):
    """The ring's pre and post stages and their backwards, each a launch of
    its own, in f32 (a shard of 256 tokens of a 1024-token sequence)."""
    _cuda_or_skip()
    bp, x, _ = _block(2, 256, 64, 1, torch.float32, seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    L = 1024
    q, k, v, u = FB.ring_pre_fwd(x, bp, L, 1)
    for got, want, what in zip((q, k, v, u),
                               FB.ring_pre_fwd_plain(x, bp, L, 1),
                               ("q", "k", "v", "u")):
        _close(got, want, what)
    av = torch.randn(x.shape, generator=g, device="cuda") * 0.05
    out = FB.ring_post_fwd(x, av, u, bp, 77, rate)
    _close(out, FB.ring_post_fwd_plain(x, av, u, bp, 77, rate), "post")
    dout = torch.randn(x.shape, generator=g, device="cuda")
    got = FB.ring_post_bwd(x, av, dout, bp, 77, rate, L, 1)
    want = FB.ring_post_bwd_plain(x, av, dout, bp, 77, rate, L, 1)
    for name in want:
        _close(got[name], want[name], f"post bwd {name}")
    cots = [torch.randn(x.shape, generator=g, device="cuda")
            for _ in range(4)]
    got = FB.ring_pre_bwd(x, bp, *cots, L, 1)
    want = FB.ring_pre_bwd_plain(x, bp, *cots, L, 1)
    for name in want:
        _close(got[name], want[name], f"pre bwd {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 512, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H", [(8, 2), (16, 4), (32, 2), (64, 1),
                                  (128, 1)])
def test_attn_bwd_kernels_match_plain_on_card(hd, H, dtype, off):
    """The HSTU attention backward of csrc/hstu_attn_bwd_sm90.cuh (the
    single device's and the ring's), through ring_pair_dq and
    ring_pair_dkdv: the wgmma kernels in bf16 (hd 8 and 16 padded to 16
    columns, 32, 64, 128), the generic ones in f32; at off 0 (the single
    device: the causal diagonal), a whole shard behind (every pair visible)
    and part of a tile behind; row 0 left-padded, the last row fully
    padded, 96 buckets for 512 tokens (the last one clamps). f32 as _close,
    bf16 as _bf16_close; one launch each."""
    _cuda_or_skip()
    B, L, D = 2, 512, hd * H
    rng = np.random.default_rng(hd * 10 + H + off)

    def t(shape, s=0.5):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dtype).cuda()

    q, k, v, dav = (t((B, L, D)) for _ in range(4))
    rab = t((H, 96), 0.1).float()
    valid = torch.ones((B, L), dtype=torch.int32, device="cuda")
    valid[0, :L // 3 + 5] = 0
    valid[-1] = 0
    counts = (FB.ring_pair_dq.launches, FB.ring_pair_dkdv.launches)
    dq, drab = FB.ring_pair_dq(q, k, v, dav, valid, rab, off, H)
    dk, dv = FB.ring_pair_dkdv(q, k, v, dav, valid, rab, off, H)
    torch.cuda.synchronize()
    assert (FB.ring_pair_dq.launches, FB.ring_pair_dkdv.launches) == \
        (counts[0] + 1, counts[1] + 1)
    want = FB.ring_pair_bwd_plain(q, k, v, dav, valid, rab, off, H)
    assert want[1][:, -1].abs().sum() > 0   # the clamped bucket is reached
    for name, got, ref in zip(("dq", "drab", "dk", "dv"), (dq, drab, dk, dv),
                              want):
        assert bool(torch.isfinite(got).all()), name
        if dtype == torch.float32:
            _close(got, ref, name)
        else:
            _bf16_close(got, ref, name)
    # the fully padded row's keys get no gradient
    assert not dk[-1].any() and not dv[-1].any()


#: (D, H) of the wgmma post-half and gate/FFN cases: D padded to 32, 64 and
#: 128 columns, heads of 8 to 128 (hd 8 and 16 padded to 16 columns)
POST_SHAPES = [(32, 1), (32, 2), (32, 4), (64, 1), (64, 2), (64, 4),
               (64, 8), (128, 1), (128, 4), (128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("D,H", POST_SHAPES)
def test_post_wgmma_kernels_match_plain_on_card(D, H, rate):
    """bf16 at D <= 128 takes attn_ffn_wgmma_kernel (forward) and
    gate_ffn_bwd_wgmma_kernel + wgrad_wgmma_kernel (backward): the
    inference and training forward (out, av), the whole-sequence backward
    (every gradient; two calls bitwise equal: no atomics), the ring's post
    stage alone on a given av (stage 1) and its backward (stage 0), each
    against its plain version, one launch each; row 0 left-padded, the last
    row fully padded."""
    _cuda_or_skip()
    B, L, bf16 = 2, 512, torch.bfloat16
    assert FB.block_wgmma(bf16, D)
    bp, x, tt = _block(B, L, D, H, bf16, seed=D + H)
    counts = {n: getattr(FB, n).launches for n in (
        "fused_hstu_block", "fused_hstu_block_train", "fused_hstu_block_bwd",
        "ring_post_fwd", "ring_post_bwd")}
    out = FB.fused_hstu_block(x, bp, tt, H)
    torch.cuda.synchronize()
    _bf16_close(out, FB.fused_hstu_block_plain(x, bp, tt, H), "inference")
    out, av = FB.fused_hstu_block_train(x, bp, tt, H, 99, rate)
    torch.cuda.synchronize()
    ref, ref_av = FB.fused_hstu_block_train_plain(x, bp, tt, H, 99, rate)
    _bf16_close(out, ref, "training out")
    _bf16_close(av, ref_av, "training av")
    dout = torch.from_numpy(np.random.default_rng(D * H).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(bf16).cuda()
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 99, rate)
    again = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 99, rate)
    torch.cuda.synchronize()
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, bp, tt, H, 99,
                                         rate)
    assert set(got) == set(want)
    for name in want:
        assert bool(torch.isfinite(got[name].float()).all()), name
        _bf16_close(got[name], want[name], name)
        assert torch.equal(got[name], again[name]), name
    u = FB.ring_pre_fwd_plain(x, bp, 2 * L, H)[3]
    av_in = (torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(D), device="cuda") * 0.05).to(bf16)
    _bf16_close(FB.ring_post_fwd(x, av_in, u, bp, 5, rate),
                FB.ring_post_fwd_plain(x, av_in, u, bp, 5, rate), "stage 1")
    got = FB.ring_post_bwd(x, av_in, dout, bp, 5, rate, 2 * L, H)
    want = FB.ring_post_bwd_plain(x, av_in, dout, bp, 5, rate, 2 * L, H)
    for name in want:
        _bf16_close(got[name], want[name], f"stage 0 {name}")
    torch.cuda.synchronize()
    assert {n: getattr(FB, n).launches - c for n, c in counts.items()} == {
        "fused_hstu_block": 1, "fused_hstu_block_train": 1,
        "fused_hstu_block_bwd": 2, "ring_post_fwd": 1, "ring_post_bwd": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("H", [1, 4])
def test_post_wgmma_kernels_chunked_variant_on_card(H, rate):
    """L=2048 > wholeseq_max_l(64), bf16: the wgmma forward rounds av to
    bf16 before LN2 (round_av) and the backward reads it, against the plain
    chunked variant; gradients bitwise equal across two calls."""
    _cuda_or_skip()
    B, L, D, bf16 = 2, 2048, 64, torch.bfloat16
    assert FB.chunked(L, D)
    bp, x, tt = _block(B, L, D, H, bf16, seed=11 + H)
    _bf16_close(FB.fused_hstu_block(x, bp, tt, H),
                FB.fused_hstu_block_plain(x, bp, tt, H), "inference")
    out, av = FB.fused_hstu_block_train(x, bp, tt, H, 7, rate)
    ref, ref_av = FB.fused_hstu_block_train_plain(x, bp, tt, H, 7, rate)
    _bf16_close(out, ref, "training out")
    _bf16_close(av, ref_av, "training av")
    dout = torch.from_numpy(np.random.default_rng(H).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(bf16).cuda()
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 7, rate)
    again = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 7, rate)
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, bp, tt, H, 7, rate)
    torch.cuda.synchronize()
    for name in want:
        _bf16_close(got[name], want[name], name)
        assert torch.equal(got[name], again[name]), name


#: (D, H) of the wgmma pre-half cases: D padded to 32, 64 and 128 columns,
#: 1 to 8 heads (hd^-1/2 scales q in the forward and dq in stage 1)
PRE_SHAPES = [(32, 1), (32, 4), (64, 1), (64, 4), (64, 8), (128, 1),
              (128, 4), (128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("D,H", PRE_SHAPES)
def test_pre_wgmma_kernels_match_plain_on_card(D, H):
    """bf16 at D <= 128 takes proj_wgmma_kernel (forward) and
    proj_bwd_wgmma_kernel + wgrad_wgmma_kernel (backward): the ring's pre
    stage (a shard of 512 tokens of 1024) and its backward (dq, dk, dv in
    bf16 as the pairs' backward returns them, du in f32, no residual), and
    the chunked block (L=2048; the whole-sequence one is in
    test_post_wgmma_kernels_match_plain_on_card) forward and backward,
    each against its plain version, one launch each; gradients bitwise
    equal across two calls (no atomics)."""
    _cuda_or_skip()
    bf16 = torch.bfloat16
    assert FB.block_wgmma(bf16, D)
    bp, x, _ = _block(2, 512, D, H, bf16, seed=3 * D + H)
    counts = {n: getattr(FB, n).launches for n in (
        "ring_pre_fwd", "ring_pre_bwd", "fused_hstu_block_train",
        "fused_hstu_block_bwd")}
    got = FB.ring_pre_fwd(x, bp, 1024, H)
    torch.cuda.synchronize()
    for name, g, w in zip("qkvu", got, FB.ring_pre_fwd_plain(x, bp, 1024,
                                                             H)):
        assert bool(torch.isfinite(g.float()).all()), name
        _bf16_close(g, w, f"stage 0 {name}")
    rng = np.random.default_rng(D * H + 7)
    cots = [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)).cuda() for _ in range(4)]
    cots = [c.to(bf16) for c in cots[:3]] + cots[3:]
    got = FB.ring_pre_bwd(x, bp, *cots, 1024, H)
    again = FB.ring_pre_bwd(x, bp, *cots, 1024, H)
    torch.cuda.synchronize()
    want = FB.ring_pre_bwd_plain(x, bp, *cots, 1024, H)
    assert set(got) == set(want)
    for name in want:
        assert bool(torch.isfinite(got[name].float()).all()), name
        _bf16_close(got[name], want[name], f"stage 1 {name}")
        assert torch.equal(got[name], again[name]), name
    L = 2048
    assert FB.chunked(L, D)
    bp, x, tt = _block(2, L, D, H, bf16, seed=5 * D + H)
    out, av = FB.fused_hstu_block_train(x, bp, tt, H, 9, 0.0)
    ref, ref_av = FB.fused_hstu_block_train_plain(x, bp, tt, H, 9, 0.0)
    _bf16_close(out, ref, "chunked out")
    _bf16_close(av, ref_av, "chunked av")
    dout = torch.from_numpy(np.random.default_rng(D + H).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(bf16).cuda()
    got = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 9, 0.0)
    again = FB.fused_hstu_block_bwd(x, ref_av, dout, bp, tt, H, 9, 0.0)
    torch.cuda.synchronize()
    want = FB.fused_hstu_block_bwd_plain(x, ref_av, dout, bp, tt, H, 9, 0.0)
    for name in want:
        assert bool(torch.isfinite(got[name].float()).all()), name
        _bf16_close(got[name], want[name], f"chunked {name}")
        assert torch.equal(got[name], again[name]), name
    assert {n: getattr(FB, n).launches - c for n, c in counts.items()} == {
        "ring_pre_fwd": 1, "ring_pre_bwd": 2, "fused_hstu_block_train": 1,
        "fused_hstu_block_bwd": 2}


@pytest.mark.gpu
def test_pre_wgmma_wrappers_raise_instead_of_falling_back_on_card(
        monkeypatch):
    """In bf16 at D <= 128 the pre stage's backward takes bf16 dq, dk, dv
    and f32 du, nothing else, and raises before a launch on another dtype
    or a misaligned operand; a launch the wgmma kernel cannot make (its
    scratch misaligned) fails in the CUDA source and raises: no fallback to
    proj_bwd_kernel."""
    _cuda_or_skip()
    bf16 = torch.bfloat16
    bp, x, _ = _block(2, 256, 64, 1, bf16, seed=21)
    cots = [torch.zeros(x.shape, dtype=bf16, device="cuda")
            for _ in range(3)] + [torch.zeros(x.shape, device="cuda")]
    before = FB.ring_pre_bwd.launches
    with pytest.raises(ValueError, match="dq must be"):
        FB.ring_pre_bwd(x, bp, cots[0].float(), *cots[1:], 512, 1)
    with pytest.raises(ValueError, match="du must be"):
        FB.ring_pre_bwd(x, bp, *cots[:3], cots[3].to(bf16), 512, 1)
    flat = torch.zeros(x.numel() + 8, dtype=bf16, device="cuda")
    shifted = flat[1:1 + x.numel()].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        FB.ring_pre_bwd(x, bp, shifted, *cots[1:], 512, 1)
    real = FB._wgmma_scratch

    def misaligned(t, F, gate=True, proj=True):
        out = real(t, F, gate, proj)
        if "h1s" in out:
            buf = torch.empty(out["h1s"].numel() + 8, dtype=t.dtype,
                              device=t.device)
            out["h1s"] = buf[4:4 + out["h1s"].numel()].view(
                out["h1s"].shape)
        return out

    monkeypatch.setattr(FB, "_wgmma_scratch", misaligned)
    with pytest.raises(RuntimeError, match="launch failed"):
        FB.ring_pre_bwd(x, bp, *cots, 512, 1)
    assert FB.ring_pre_bwd.launches == before


def _pair_operands(B, Lq, Lk, D, H, seed):
    """bf16 q [B, Lq, D], k and v [B, Lk, D], f32 rab [H, 128] and key
    validity (row 0 left-padded) on the card, from numpy with a seed."""
    rng = np.random.default_rng(seed)

    def t(shape, s=0.5):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).cuda()

    q, k, v = (t((B, L, D)).to(torch.bfloat16) for L in (Lq, Lk, Lk))
    valid = torch.ones((B, Lk), dtype=torch.int32, device="cuda")
    valid[0, :min(37, Lk)] = 0
    return q, k, v, valid, t((H, 128), 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("off", [0, 256, -256, 768, 96, -48])
@pytest.mark.parametrize("D,H", [(64, 1), (64, 4), (64, 8), (32, 4),
                                 (128, 1)])
def test_pair_fwd_wgmma_kernel_matches_plain_on_card(D, H, off):
    """Row 10 in bf16 (pair_fwd_wgmma_kernel, the attention loop of
    attn_ffn_wgmma_kernel at a token offset) against ring_pair_fwd_plain:
    the same shard, a past one, a future one (no launch, exactly 0), a far
    past one, offsets off the 64-row tiles either way; hd 8 to 128. bf16
    tolerance: one bf16 step of the largest value, cosine 0.999 (a rounds
    to bf16 as the product's operand in both; sums in another order)."""
    _cuda_or_skip()
    B, L = 2, 256
    q, k, v, valid, rab = _pair_operands(B, L, L, D, H, 4000 + D + H + off)
    n = FB.ring_pair_fwd.launches
    out = FB.ring_pair_fwd(q, k, v, valid, rab, off, H)
    torch.cuda.synchronize()
    assert FB.ring_pair_fwd.launches == n + (off + L > 0)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    ref = FB.ring_pair_fwd_plain(q, k, v, valid, rab, off, H)
    if off + L <= 0:
        assert not out.any()
        return
    _bf16_close(out, ref, f"pair forward D={D} H={H} off={off}")
    if off < 0:   # the first -off query rows see no key at all
        assert not out[:, :-off].any()


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,Lk,off", [(272, 144, 0), (144, 272, 128),
                                       (208, 208, -16), (16, 48, 32)])
def test_pair_fwd_wgmma_kernel_ragged_shards_on_card(Lq, Lk, off):
    """Shards whose lengths are multiples of 16 but not of 64, and Lq !=
    Lk: the last query tile stores only its rows, the last key tile loads
    zero rows with invalid flags past the shard's end."""
    _cuda_or_skip()
    q, k, v, valid, rab = _pair_operands(3, Lq, Lk, 64, 4, Lq + Lk + off)
    out = FB.ring_pair_fwd(q, k, v, valid, rab, off, 4)
    ref = FB.ring_pair_fwd_plain(q, k, v, valid, rab, off, 4)
    assert out.shape == (3, Lq, 64)
    _bf16_close(out, ref, f"pair forward Lq={Lq} Lk={Lk} off={off}")


@pytest.mark.gpu
def test_pair_fwd_wgmma_kernel_writes_zeros_where_no_key_is_visible_on_card():
    """A query tile that sees no key (off = -Lc / 2: the first half of the
    shard's queries precede every key) still writes its rows: exactly 0,
    although the output's memory held NaNs before (the wrapper allocates it
    with torch.empty)."""
    _cuda_or_skip()
    B, L, D, H = 2, 512, 64, 1
    q, k, v, valid, rab = _pair_operands(B, L, L, D, H, 17)
    for _ in range(3):   # NaNs in the blocks the allocator hands out next
        junk = torch.full((B, L, D), float("nan"), device="cuda")
        del junk
        out = FB.ring_pair_fwd(q, k, v, valid, rab, -L // 2, H)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert not out[:, :L // 2].any()
        assert out[:, L // 2:].abs().sum() > 0


@pytest.mark.gpu
def test_pair_fwd_wgmma_route_raises_instead_of_falling_back_on_card():
    """In bf16 with heads the attention loop takes, a launch the wgmma
    kernel cannot make (16 heads of 128 columns: their q tiles alone need
    256 KB of shared memory) fails in the CUDA source and the wrapper
    raises; it does not fall back to pair_fwd_kernel."""
    _cuda_or_skip()
    q, k, v, valid, rab = _pair_operands(1, 64, 64, 2048, 16, 5)
    n = FB.ring_pair_fwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        FB.ring_pair_fwd(q, k, v, valid, rab, 0, 16)
    assert FB.ring_pair_fwd.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_bytes", [16, 2048, 4096])
def test_group_gather_interleaved_slots_on_card(dtype, row_bytes):
    """The gather on unsorted real groups with sentinel slots between them,
    K a multiple of no block's share (2777 slots), rows of 16 B, 2 KB and 4
    KB: every real slot's row bitwise equal to the plain gather's; one
    launch a call."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import sparse_table as ST

    rng = np.random.default_rng(row_bytes)
    nG, K, W = 3000, 2777, row_bytes // dtype.itemsize
    table = torch.randn((nG, W), generator=torch.Generator().manual_seed(3)
                        ).to(dtype).cuda()
    slots = rng.permutation(nG)[:K].astype(np.int32)
    slots[rng.random(K) < 0.1] = nG
    g = torch.from_numpy(slots).cuda()
    real = g < nG
    n = ST.group_gather.launches
    got = ST.group_gather(table, g)
    torch.cuda.synchronize()
    assert ST.group_gather.launches == n + 1
    assert torch.equal(got[real], ST.group_gather_plain(table, g)[real])


# ---------------------------------------------------------------------------
# the standalone HSTU attention on wgmma (bf16, hd % 8 == 0, hd <= 128)
# ---------------------------------------------------------------------------

#: (D, H) of each head width the wgmma route takes: hd 8 (padded to 16
#: columns), 16, 32, 64, 128
HSTU_WGMMA_HEADS = [(32, 4), (64, 4), (64, 2), (64, 1), (128, 1)]
HSTU_WGMMA_FWD = ("hstu_fwd_wgmma_kernel",)
HSTU_WGMMA_BWD = ("attn_bwd_dq_wgmma_kernel", "attn_bwd_dkdv_wgmma_kernel",
                  "reduce_rows_split_kernel")
HSTU_FIRST_DESIGN = ("hstu_fwd_kernel", "hstu_bwd_dq_kernel",
                     "hstu_bwd_dkdv_kernel")


def _token_close(got, ref, what):
    """An attention output in bf16: max abs <= 3e-2 * max(1, max|ref|), the
    lowest cosine over the tokens with a visible key >= 0.9995, and the
    tokens with none exactly 0."""
    g, r = got.float(), ref.float()
    live = r.abs().amax(-1) > 0
    assert not g[~live].any(), what
    assert (g - r).abs().max() <= 3e-2 * max(1.0, r.abs().max()), what
    cos = torch.nn.functional.cosine_similarity(g[live], r[live], dim=-1)
    assert cos.min() >= 0.9995, (what, cos.min().item())


def _hstu_wgmma_case(B, L, D, H, NB, seed):
    """Kernel forward and backward against the plain versions in bf16 (the
    output as _token_close, the gradients as _bf16_close), the padded keys
    and queries of row 0 and the fully padded last row exactly 0; returns
    (out, grads) of the kernels."""
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    q, k, v, dout, valid, rab = _attention(B, L, D, H, torch.bfloat16, seed,
                                           NB)
    out = HA.hstu_attention_fwd(q, k, v, valid, rab, L, H)
    grads = HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L, H)
    torch.cuda.synchronize()
    _token_close(out, HA.hstu_attention_fwd_plain(q, k, v, valid, rab, L, H),
                 f"out hd={D // H} L={L} NB={NB}")
    want = HA.hstu_attention_bwd_plain(q, k, v, dout, valid, rab, L, H)
    pad = L // 3 + 5
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, want):
        assert bool(torch.isfinite(g.float()).all()), name
        _bf16_close(g, r, f"{name} hd={D // H} L={L} NB={NB}")
        if name != "drab":
            assert g.dtype == torch.bfloat16, name
            assert not g[-1].any() and not g[0, :pad].any(), name
    assert not out[-1].any() and not out[0, :pad].any()
    return out, grads


@pytest.mark.gpu
@pytest.mark.parametrize("L", [256, 512, 4096])
@pytest.mark.parametrize("D,H", HSTU_WGMMA_HEADS)
def test_hstu_wgmma_kernels_match_plain_on_card(D, H, L):
    """hd 8 to 128 at L = 256, 512 (whole sequence) and 4096 (the chunked
    route's counters): one launch each way on the route's counters, held
    to the plain versions in bf16."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    counters = (HA.hstu_attention_fwd, HA.hstu_attention_bwd,
                HA.hstu_attention_chunk_fwd, HA.hstu_attention_chunk_bwd)
    before = [c.launches for c in counters]
    _hstu_wgmma_case(2, L, D, H, 128, 60 + L // 256 + D + H)
    want = [0, 0, 1, 1] if HA._use_long(L, D) else [1, 1, 0, 0]
    assert [c.launches - b for c, b in zip(counters, before)] == want


@pytest.mark.gpu
@pytest.mark.parametrize("NB,D,H", [
    (32, 64, 4), (128, 64, 4), (300, 64, 4), (898, 64, 1), (1794, 64, 1),
    (1794, 32, 4), (1794, 64, 2), (1794, 128, 1)])
def test_hstu_wgmma_bucket_counts_on_card(NB, D, H):
    """The bucket counts the JAX package takes, up to 898 on its
    whole-sequence route and 1794 on its chunked one (L=2048: distances
    past the last bucket clamp), 1794 at every padded head width W = 16,
    32, 64, 128 (the dq kernel holds the [NB] partial in shared memory):
    held to the plain versions, and a second call bitwise equal to the
    first (drab sums in a fixed order)."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    L = 512 if NB <= 300 else 2048
    out, grads = _hstu_wgmma_case(2, L, D, H, NB, NB + D)
    q, k, v, dout, valid, rab = _attention(2, L, D, H, torch.bfloat16,
                                           NB + D, NB)
    assert torch.equal(HA.hstu_attention_fwd(q, k, v, valid, rab, L, H), out)
    for g, again in zip(grads, HA.hstu_attention_bwd(q, k, v, dout, valid,
                                                     rab, L, H)):
        assert torch.equal(g, again)


def _profiled_names(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,H,wgmma", [
    (torch.bfloat16, 64, 4, True), (torch.bfloat16, 32, 4, True),
    (torch.float32, 64, 4, False), (torch.bfloat16, 192, 1, False),
    (torch.bfloat16, 2048, 16, False)])
def test_hstu_wgmma_route_by_profiler_names_on_card(dtype, D, H, wgmma):
    """bf16 at hd 16 and 8 runs hstu_fwd_wgmma_kernel and the wgmma
    backward pair with reduce_rows_split_kernel, and none of the first
    design's kernels; f32, hd 192 and heads whose held q tiles would not
    fit shared memory (16 of 128) run the first design and no wgmma
    kernel."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    L = 256
    q, k, v, dout, valid, rab = _attention(2, L, D, H, dtype, 3)
    names = _profiled_names(lambda: (
        HA.hstu_attention_fwd(q, k, v, valid, rab, L, H),
        HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L, H)))

    def ran(kernel):
        return any(kernel in n for n in names)

    new, old = HSTU_WGMMA_FWD + HSTU_WGMMA_BWD, HSTU_FIRST_DESIGN
    assert all(ran(n) == wgmma for n in new), names
    assert all(ran(n) != wgmma for n in old), names


@pytest.mark.gpu
def test_hstu_wgmma_misaligned_view_raises_on_card(monkeypatch):
    """A q that is contiguous but 2 bytes off a 16-byte boundary: the
    wrapper raises before a launch; with the wrapper's check taken away the
    wgmma launch itself fails and the wrapper raises; nothing falls back to
    the first design and no counter moves."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    B, L, D, H = 2, 256, 64, 4
    q, k, v, dout, valid, rab = _attention(B, L, D, H, torch.bfloat16, 4)
    buf = torch.empty(B * L * D + 8, dtype=torch.bfloat16, device="cuda")
    off = buf[1:1 + B * L * D].view(B, L, D)
    off.copy_(q)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    counters = (HA.hstu_attention_fwd, HA.hstu_attention_bwd)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="16-byte aligned"):
        HA.hstu_attention_fwd(off, k, v, valid, rab, L, H)
    monkeypatch.setattr(HA, "check_attention_inputs", lambda *a: None)
    with pytest.raises(RuntimeError, match="launch failed"):
        HA.hstu_attention_fwd(off, k, v, valid, rab, L, H)
    with pytest.raises(RuntimeError, match="launch failed"):
        HA.hstu_attention_bwd(off, k, v, dout, valid, rab, L, H)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before


def _train_world(tmp_path, **train):
    """hstu_flagship at D=64, 2 blocks, L=256, batch 8, bf16, dropout 0 and
    tower dedup off, on a seeded synthetic fixture, with its first batch on
    the card."""
    import dataclasses

    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data import synthetic
    from tencent_recommendation_2025_tpu_torch.data.dataset import \
        TrainSampler
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.pipeline import \
        TrainLoader
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    synthetic.generate(tmp_path / "data", num_users=32, num_items=100,
                       min_seq=200, max_seq=300, mm_emb_ids=("81",), seed=7)
    cfg = PRESETS["hstu_flagship"]()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, maxlen=255, num_blocks=2,
                                  dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, batch_size=8, tower_dedup=False,
                                  **train))
    data = TencentGRData(tmp_path / "data", mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    tables = TR.device_tables(build_item_tables(
        data.item_feat_dict, data.itemnum, schema, data.mm_emb_dict,
        data.indexer_i_rev), "cuda")
    sampler = TrainSampler(data, schema, cfg.model.maxlen)
    raw = next(iter(TrainLoader(sampler, np.arange(len(sampler)), 8,
                                seed=1).epoch(1)))
    return cfg, model, tables, TR.put_batch(raw, "cuda")


@pytest.mark.gpu
def test_grad_accum_step_matches_whole_batch_on_card(tmp_path):
    """One bf16 step at G=4 (2 rows a launch) against G=1 from the same
    parameters: loss within 1e-3 relative, every gradient at cosine >=
    0.999, the fused training forward and backward launched 4 times as
    often."""
    import dataclasses

    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _train_world(tmp_path)
    params = TR.init_state(model, cfg, device="cpu").params
    out = {}
    for G in (1, 4):
        c = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  grad_accum_steps=G))
        state = TR.init_state(model, c, params=params, device="cuda")
        before = (FB.fused_hstu_block_train.launches,
                  FB.fused_hstu_block_bwd.launches)
        state, m = TR.make_train_step(model, c)(state, batch, tables["mm"],
                                                tables)
        torch.cuda.synchronize()
        out[G] = (float(m["loss"]),
                  {p: t.grad.float() for p, t in TR.param_leaves(
                      state.params)},
                  (FB.fused_hstu_block_train.launches - before[0],
                   FB.fused_hstu_block_bwd.launches - before[1]))
    (l1, g1, n1), (l4, g4, n4) = out[1], out[4]
    assert n1 == (2, 2) and n4 == (8, 8)
    assert abs(l4 - l1) <= 1e-3 * abs(l1)
    for p, g in g1.items():
        a, b = g.flatten(), g4[p].flatten()
        if a.norm() == 0 and b.norm() == 0:
            continue
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
        assert cos >= 0.999, (p, cos)


@pytest.mark.gpu
def test_async_checkpoint_snapshot_is_bitwise_on_card(tmp_path):
    """A save_checkpoint_async of a state on the card, with a train step
    updating the state in place while the files are written, equals a
    synchronous save of the same state, file for file."""
    import json

    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.train import checkpoint as CK
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _train_world(tmp_path)
    state = TR.init_state(model, cfg, device="cuda")
    step = TR.make_train_step(model, cfg)
    state, _ = step(state, batch, tables["mm"], tables)
    sync = CK.save_checkpoint(tmp_path / "sync", state, 1)
    handle = CK.save_checkpoint_async(tmp_path / "async", state, 1)
    state, _ = step(state, batch, tables["mm"], tables)
    path = handle.result()
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest == json.loads((sync / "manifest.json").read_text())
    for e in manifest["leaves"]:
        np.testing.assert_array_equal(np.load(path / e["file"]),
                                      np.load(sync / e["file"]),
                                      err_msg=e["path"])
    assert state.step == 2


@pytest.mark.gpu
def test_pipe_mesh_step_matches_single_device_on_card(tmp_path):
    """One bf16 step on a local mesh of pipe 2 x data 2 with 4 microbatches
    a data column (1 row a fused launch, 1 block a stage) against the
    single device's fused step from the same parameters: loss within 1e-4
    relative, every gradient at cosine >= 0.999 (the tables' at their
    rows), the fused training forward and backward launched once a block
    and microbatch (2 x 4 x 2 = 16 times)."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel import train as PT
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh
    from tencent_recommendation_2025_tpu_torch.train import trainer as TR

    cfg, model, tables, batch = _train_world(tmp_path)
    params = TR.init_state(model, cfg, device="cpu").params
    mesh = local_mesh(MeshConfig(pipe=2, data=2, pp_microbatches=4))
    out = {}
    for side, m_ in (("single", None), ("mesh", mesh)):
        state = TR.init_state(model, cfg, params=params, device="cuda")
        tb = tables
        if m_ is not None:
            state = PT.shard_existing_state(m_, state)
            tb = PT.shard_tables(m_, tables)
        before = (FB.fused_hstu_block_train.launches,
                  FB.fused_hstu_block_bwd.launches)
        state, m = TR.make_train_step(model, cfg, m_)(state, batch,
                                                      tb["mm"], tb)
        torch.cuda.synchronize()
        out[side] = (float(m["loss"]),
                     {p: t.grad.float() for p, t in TR.dense_leaves(
                         state.params, cfg)},
                     (FB.fused_hstu_block_train.launches - before[0],
                      FB.fused_hstu_block_bwd.launches - before[1]))
    (l1, g1, n1), (lp, gp, npp) = out["single"], out["mesh"]
    assert n1 == (2, 2) and npp == (16, 16)
    assert abs(lp - l1) <= 1e-4 * abs(l1)
    for p, g in g1.items():
        a, b = g.flatten(), gp[p][:len(g)].flatten()
        if a.norm() == 0 and b.norm() == 0:
            continue
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
        assert cos >= 0.999, (p, cos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,D,H", [(256, 64, 4), (512, 64, 1),
                                   (512, 128, 1), (2048, 64, 4),
                                   (256, 256, 1), (256, 1024, 1)])
def test_hstu_silu_qkv_kernels_match_plain_on_card(L, D, H, dtype):
    """The silu_qkv instances (pre-activation q, k, v: the SiLU as the
    tiles land, dsilu in the backward's stores) against their plain
    versions: W = 16, 64 and 128 on the whole-sequence route, the chunked
    route at L=2048, hd 256 and the sliced hd 1024 on the first design; f32
    (the first design) and bf16. One launch each way on the route's
    ``silu_launches`` and none on ``launches``; a second call bitwise
    equal."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as HA

    q, k, v, dout, valid, rab = _attention(2, L, D, H, dtype, 70 + D + H)
    counters = (HA.hstu_attention_fwd, HA.hstu_attention_bwd,
                HA.hstu_attention_chunk_fwd, HA.hstu_attention_chunk_bwd)
    before = [(c.launches, c.silu_launches) for c in counters]
    out = HA.hstu_attention_fwd(q, k, v, valid, rab, L, H, silu_qkv=True)
    grads = HA.hstu_attention_bwd(q, k, v, dout, valid, rab, L, H,
                                  silu_qkv=True)
    torch.cuda.synchronize()
    one = (0, 1)
    want = [(0, 0)] * 2 + [one] * 2 if HA._use_long(L, D) \
        else [one] * 2 + [(0, 0)] * 2
    assert [(c.launches - a, c.silu_launches - b)
            for c, (a, b) in zip(counters, before)] == want
    ref = HA.hstu_attention_fwd_plain(q, k, v, valid, rab, L, H, True)
    refs = HA.hstu_attention_bwd_plain(q, k, v, dout, valid, rab, L, H,
                                       True)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, refs):
            _close(g, r, name)
    else:
        for name, g, r in zip(("out", "dq", "dk", "dv", "drab"),
                              (out, *grads), (ref, *refs)):
            _bf16_close(g, r, name)
    assert torch.equal(out, HA.hstu_attention_fwd(q, k, v, valid, rab, L, H,
                                                  silu_qkv=True))
    for g, g2 in zip(grads, HA.hstu_attention_bwd(q, k, v, dout, valid, rab,
                                                  L, H, silu_qkv=True)):
        assert torch.equal(g, g2)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_fused_feature_lookup_backward_is_repeatable_on_card(shards):
    """The fused-feature lookup's one-hot backward (a stable sort and a
    segmented sum) gives the same bits over two calls, on one device and
    on a local data mesh of 2 shards; an id above its slot's vocabulary
    sends nothing; the sums match an f64 index_add_ of the kept rows
    within 1e-5 of the largest sum."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.models import embedding as TE
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as SE
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    rng = np.random.default_rng(4)
    sizes = [2000, 1500, 40, 40, 40]
    offs = [0, 2001, 3502, 3502, 3502]
    V, D = 3544, 64
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(
        np.float32)).cuda()
    ids = torch.from_numpy(np.stack(
        [rng.integers(0, int(1.2 * s) + 1, (64, 256)) for s in sizes],
        axis=-1)).cuda()
    cot = torch.from_numpy(rng.standard_normal(tuple(ids.shape) + (D,))
                           .astype(np.float32)).cuda()

    def grad():
        leaf = SE.pad_rows(table, shards).clone().requires_grad_(True)
        src = leaf if shards == 1 else SE.ShardedTable.of_leaf(
            leaf, local_mesh(MeshConfig(data=shards)))
        loss = 0.0
        for s in range(shards):   # each data shard's batch rows in turn
            part = slice(s * 64 // shards, (s + 1) * 64 // shards)
            out = TE.fused_feature_lookup(src, ids[part], offs, sizes=sizes)
            loss = loss + (out * cot[part]).sum()
        loss.backward()
        return leaf.grad[:V]

    g1, g2 = grad(), grad()
    assert torch.equal(g1, g2)
    sz = torch.tensor(sizes, device="cuda")
    live = (ids > 0) & (ids <= sz)
    rows = ids + torch.tensor(offs, device="cuda")
    want = torch.zeros((V, D), dtype=torch.float64, device="cuda").index_add_(
        0, rows[live], cot[live].double())
    # f32 sums of up to ~1,200 terms a row, in another order than f64's
    err = (g1.double() - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


# ---------------------------------------------------------------------------
# the exact top-k scan (csrc/mips_topk.cu) against its plain version
# ---------------------------------------------------------------------------

def _mips_operands(Q, N, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((Q, D), generator=g, device="cuda"),
            torch.randn((N, D), generator=g, device="cuda"))


def _mips_agree(queries, corpus, k, base=0, n_valid=None):
    """The kernel's result twice and the plain version's on the same card
    tensors: ids equal, two calls bitwise equal, one launch a call, the
    queries counted, and scores within 1e-5 of the query's score scale
    (|q| times the corpus rows' rms: f32 sums in two orders)."""
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as M
    from tencent_recommendation_2025_tpu_torch.utils import tracing as TRC

    torch.backends.cuda.matmul.allow_tf32 = False
    want_s, want_i = M._topk_mips_plain(queries, corpus, k, base=base,
                                        n_valid=n_valid)
    n, kq = M.mips_topk.launches, TRC.counters().get("mips.kernel_queries", 0)
    got_s, got_i = M.topk_mips(queries, corpus, k, base=base,
                               n_valid=n_valid)
    again_s, again_i = M.mips_topk(queries, corpus, k, base=base,
                                   n_valid=n_valid)
    torch.cuda.synchronize()
    assert M.mips_topk.launches == n + 2
    assert TRC.counters()["mips.kernel_queries"] == kq + 2 * len(queries)
    assert torch.equal(got_s, again_s) and torch.equal(got_i, again_i)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.long
    assert torch.equal(got_i, want_i), (got_i != want_i).sum().item()
    scale = queries.norm(dim=1, keepdim=True) \
        * corpus.pow(2).sum(1).mean().sqrt()
    assert bool(((got_s - want_s).abs() <= 1e-5 * scale).all())
    return got_s, got_i


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,D,k", [
    (1, 1_000_003, 64, 10), (7, 65_537, 16, 128), (1024, 1_000_003, 64, 10),
    (4096, 65_537, 128, 20), (7, 5, 512, 10), (1, 300, 16, 128),
    (1024, 300, 512, 1), (4096, 1_000_003, 16, 128), (7, 1_000_003, 128, 1),
    (1024, 65_537, 512, 20), (4096, 5, 64, 1), (1, 65_537, 512, 20),
    (7, 300, 13, 10), (1024, 65_537, 62, 10)])
def test_mips_topk_kernel_matches_plain_on_card(Q, N, D, k):
    """The kernel against ``_topk_mips_plain`` on the same card tensors,
    k > N included (places no row fills hold the lowest f32 and row 0), D
    not a multiple of 4 (the 4-byte copies), and ``topk_mips_approx``
    bitwise the exact tier's result."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as M

    queries, corpus = _mips_operands(Q, N, D, seed=Q + N + D + k)
    s, i = _mips_agree(queries, corpus, k)
    if k > N:
        assert bool((s[:, N:] == torch.finfo(torch.float32).min).all())
        assert not i[:, N:].any()
    a_s, a_i = M.topk_mips_approx(queries, corpus, k)
    assert torch.equal(a_s, s) and torch.equal(a_i, i)


@pytest.mark.gpu
@pytest.mark.parametrize("base,n_valid", [(0, 2000), (4000, 5500),
                                          (8000, 5500), (0, None)])
def test_mips_topk_kernel_honours_a_shards_pad_rows_on_card(base, n_valid):
    """A shard of 4,000 rows whose row 0 is global row ``base``, rows at or
    past global ``n_valid`` zero pad rows: every real score is negative, so
    a pad row scored would win. Indices are global rows; a shard of pad
    rows only returns (lowest f32, 0) everywhere."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(7)
    shard = -(torch.rand((4000, 64), generator=g, device="cuda") + 1.0)
    queries = torch.rand((33, 64), generator=g, device="cuda") + 0.1
    if n_valid is not None:
        shard[max(0, n_valid - base):] = 0.0
    s, i = _mips_agree(queries, shard, 20, base=base, n_valid=n_valid)
    real = 4000 if n_valid is None else max(0, min(4000, n_valid - base))
    if real == 0:
        assert bool((s == torch.finfo(torch.float32).min).all())
        assert not i.any()
    else:
        assert bool((s < 0).all()) and bool((i >= base).all())
        assert bool((i < base + real).all())


@pytest.mark.gpu
def test_mips_topk_kernel_breaks_ties_to_the_lower_row_on_card():
    """Copies of one row placed across the kernel's tile (128 rows) and
    slice boundaries, more copies than k: every query's top k are the k
    lowest rows of the copies, scores bitwise equal, as the plain
    version's tie rescan returns them."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as M

    Q, N, D, k = 7, 1_000_003, 64, 5
    queries, corpus = _mips_operands(Q, N, D, seed=11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = M.scan_plan(Q, N, k, D, sms)
    assert plan.slices > 4
    at = sorted({127, 128, 255} | {s * plan.rows + d for s in (1, 2, 3)
                                    for d in (-1, 0)})
    assert len(at) > k
    corpus[at] = 10.0 * queries[0] / queries[0].norm()
    queries[1:] = queries[0]
    s, i = _mips_agree(queries, corpus, k)
    want = torch.tensor(at[:k], device="cuda").expand(Q, k)
    assert torch.equal(i, want)
    assert bool((s == s[:, :1]).all())


@pytest.mark.gpu
def test_mips_topk_kernel_limits_raise_on_card():
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as M

    queries, corpus = _mips_operands(4, 1000, 64, seed=3)
    with pytest.raises(ValueError, match="KERNEL_MAX_K"):
        M.topk_mips(queries, corpus, k=M.KERNEL_MAX_K + 1)
    wide = torch.zeros((4, M.KERNEL_MAX_D + 1), device="cuda")
    with pytest.raises(ValueError, match="KERNEL_MAX_D"):
        M.topk_mips(wide, wide, k=1)


@pytest.mark.gpu
def test_mips_topk_kernel_reads_a_query_view_in_place_on_card():
    """Queries as ``predict`` returns them, the last position of [Q, L, D]
    activations (rows L * D floats apart), give the contiguous copy's
    result bitwise; rows of stride 0 (an expanded query) are copied."""
    _cuda_or_skip()
    from tencent_recommendation_2025_tpu_torch.retrieval import mips as M

    g = torch.Generator(device="cuda").manual_seed(9)
    acts = torch.randn((300, 5, 64), generator=g, device="cuda")
    corpus = torch.randn((70_000, 64), generator=g, device="cuda")
    view = acts[:, -1, :]
    assert view.stride(0) == 5 * 64
    s, i = M.mips_topk(view, corpus, 10)
    want_s, want_i = M.mips_topk(view.contiguous(), corpus, 10)
    assert torch.equal(s, want_s) and torch.equal(i, want_i)
    one = acts[0, -1][None, :].expand(7, 64)
    s, i = M.mips_topk(one, corpus, 10)
    want_s, want_i = M.mips_topk(one.contiguous(), corpus, 10)
    assert torch.equal(s, want_s) and torch.equal(i, want_i)
