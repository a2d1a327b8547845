"""The port's fused HSTU block (tencent_recommendation_2025_tpu_torch/ops/
fused_block.py) against the JAX package's fused Pallas kernel, run in
interpret mode on the CPU. The CUDA kernel itself is checked on the card
(chip_smoke.py, and the ``gpu``-marked test below)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import ModelConfig
from tencent_recommendation_2025_tpu.models import encoder as JENC
from tencent_recommendation_2025_tpu.ops import fused_block as JFB
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.models.embedding import layernorm
from tencent_recommendation_2025_tpu_torch.models.hstu import hstu_block
from tencent_recommendation_2025_tpu_torch.ops import fused_block as TFB

torch.set_num_threads(2)


def _cfg(D=16, H=2, buckets=128):
    return ModelConfig(hidden_units=D, num_heads=H, block_type="hstu",
                       ffn_type="swiglu", hstu_rel_pos_buckets=buckets,
                       dtype="float32", dropout_rate=0.0,
                       reference_init=False)


def _setup(B=2, L=256, D=16, H=2, seed=0):
    """JAX block params with every LN/bias leaf perturbed off its init (so
    all of them matter), seeded inputs, left padding, and — for B > 1 — one
    fully padded row."""
    cfg = _cfg(D, H)
    rng = np.random.default_rng(seed)
    params = JENC.init_block_params(jax.random.key(seed), cfg)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                  a.dtype), params)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    tt = np.ones((B, L), np.int32)
    tt[0, :19] = 0
    if B > 1:
        tt[1, :] = 0
    return cfg, params, x, tt


def _jax_fused(params, x, tt, H):
    return np.asarray(JFB.fused_hstu_block(
        jnp.asarray(x), params, jnp.asarray(tt), jnp.int32(0), H,
        interpret=True))


def _torch(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


def _ops(params):
    """Kernel operands of one JAX block, in f32."""
    return TFB.block_operands(_torch(params), torch.float32)


def _eager_block(bp, x, tt, H):
    """The port's dense encoder wiring of one block (the oracle route)."""
    mask = TENC.attention_mask(tt, tt)
    h = layernorm(bp["attn_ln"], x)
    x = x + hstu_block(bp["hstu"], h, mask, H)
    h = layernorm(bp["ffn_ln"], x)
    return x + TENC.ffn(bp["ffn"], h)


@pytest.mark.parametrize("B,L,D,H", [(2, 256, 16, 2), (1, 384, 64, 1)])
def test_plain_matches_jax_fused_kernel(B, L, D, H):
    cfg, params, x, tt = _setup(B, L, D, H)
    ref = _jax_fused(params, x, tt, H)
    out = TFB.fused_hstu_block(torch.from_numpy(x), _ops(params),
                               torch.from_numpy(tt), H).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_eager_wiring_matches_jax_fused_kernel():
    cfg, params, x, tt = _setup(B=2, L=256, D=16, H=2, seed=3)
    ref = _jax_fused(params, x, tt, 2)
    out = _eager_block(_torch(params), torch.from_numpy(x),
                       torch.from_numpy(tt), 2).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_two_stacked_blocks():
    cfg, p1, x, tt = _setup(B=2, L=256, D=16, H=2, seed=7)
    _, p2, _, _ = _setup(B=2, L=256, D=16, H=2, seed=11)
    ref = _jax_fused(p2, _jax_fused(p1, x, tt, 2), tt, 2)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), p1, p2)
    # operands of both blocks built at once, as the encoder builds them
    ops = TFB.block_operands(params_from_jax(stacked), torch.float32)
    xt, ttt = torch.from_numpy(x), torch.from_numpy(tt)
    for i in range(2):
        xt = TFB.fused_hstu_block(xt, TENC.block_params(ops, i), ttt, 2)
    np.testing.assert_allclose(xt.numpy(), ref, rtol=1e-4, atol=2e-5)


def test_supported_gate():
    """test_fused_block.test_supported_gate with 'cuda' for 'tpu'."""
    cfg = _cfg(D=64, H=1)
    assert TFB.fused_block_supported(cfg, 1024, "cuda")
    assert not TFB.fused_block_supported(cfg, 1024, "cpu")
    assert not TFB.fused_block_supported(cfg, 1024, "tpu")
    for L in (2048, 4096, 8192, 16384, 2176):
        assert TFB.fused_block_supported(cfg, L, "cuda")
    assert not TFB.fused_block_supported(cfg, 32768, "cuda")
    assert not TFB.fused_block_supported(cfg, 100, "cuda")
    assert not TFB.fused_block_supported(cfg, 1025, "cuda")
    for D, H in ((128, 1), (256, 1)):
        assert TFB.fused_block_supported(_cfg(D=D, H=H), 1024, "cuda")
        assert TFB.wholeseq_max_l(D) == 1024 * 64 // D
    assert not TFB.fused_block_supported(_cfg(D=512, H=1), 1024, "cuda")
    assert TFB._chunk_of(1024, 64) == 512
    assert TFB._chunk_of(1024, 128) == 512
    assert TFB._chunk_of(1024, 256) == 256
    assert not TFB.fused_block_supported(
        dataclasses.replace(cfg, ffn_type="relu"), 1024, "cuda")
    assert not TFB.fused_block_supported(
        dataclasses.replace(cfg, block_type="mha"), 1024, "cuda")
    assert not TFB.fused_block_supported(
        dataclasses.replace(cfg, fused_block=False), 1024, "cuda")
    # the two packages' gates agree shape for shape
    for D, H, L in ((16, 2, 256), (64, 1, 1024), (64, 4, 512), (64, 16, 512),
                    (32, 2, 384), (512, 1, 256), (64, 1, 1000)):
        c = _cfg(D=D, H=H)
        assert TFB.fused_block_supported(c, L, "cuda") == \
            JFB.fused_block_supported(c, L, "tpu"), (D, H, L)


def test_cpu_tensors_take_the_plain_version():
    TFB.fused_hstu_block.launches = 0
    cfg, params, x, tt = _setup(B=1, L=256, D=16, H=2, seed=5)
    tp = _ops(params)
    out = TFB.fused_hstu_block(torch.from_numpy(x), tp,
                               torch.from_numpy(tt), 2)
    plain = TFB.fused_hstu_block_plain(torch.from_numpy(x), tp,
                                       torch.from_numpy(tt), 2)
    assert TFB.fused_hstu_block.launches == 0
    assert torch.equal(out, plain)
    with pytest.raises(ValueError, match="no kernel"):
        TFB.fused_hstu_block(torch.from_numpy(x).to("meta"), tp,
                             torch.from_numpy(tt), 2)


def test_encoder_block_route():
    """The encoder's routing on the card: the flagship at L=1024 takes the
    fused kernel, and so does L=2048 (its chunked variant); the preset's
    default maxlen=1024 gives L=1025, which runs plain; a block the fused
    gate refuses (a ReLU FFN) takes the standalone HSTU attention kernels
    ("core"), whole-sequence or past their ceiling chunked, as the JAX
    package takes its Pallas kernels. On the CPU every shape runs plain."""
    cfg = _cfg(D=64, H=1)
    assert TENC.block_route(cfg, 1024, "cuda") == "fused"
    assert TENC.block_route(cfg, 256, "cuda") == "fused"
    assert TENC.block_route(cfg, 1025, "cuda") == "dense"
    assert TENC.block_route(cfg, 128, "cuda") == "dense"
    assert TENC.block_route(cfg, 2048, "cuda") == "fused"
    assert TFB.chunked(2048, 64) and not TFB.chunked(1024, 64)
    relu = dataclasses.replace(cfg, ffn_type="relu")
    assert TENC.block_route(relu, 512, "cuda") == "core"
    assert TENC.block_route(relu, 2048, "cuda") == "core"
    no_kernels = dataclasses.replace(relu, use_flash_attention=False)
    assert TENC.block_route(no_kernels, 512, "cuda") == "dense"
    for L in (128, 1024, 1025, 2048):
        assert TENC.block_route(cfg, L, "cpu") == "dense"


@pytest.mark.parametrize("fault", ["none", "dropped", "shifted", "clamped"])
def test_card_bf16_check_catches_a_wrong_rel_pos_bias(fault):
    """chip_smoke's bf16 kernel-vs-plain check (max abs and per-token
    cosine) passes the plain version against itself and fails it against a
    plain version whose rel-pos bias is dropped, read one distance off, or
    clamped at half the buckets."""
    import chip_smoke

    x, ops, tt = chip_smoke.block_inputs(B=2, L=512, D=64, H=1, F=256,
                                         NB=128, dtype=torch.bfloat16,
                                         seed=11, device="cpu")
    ref = TFB.fused_hstu_block_plain(x, ops, tt, 1)
    rab = ops["rab"]
    wrong = {"none": rab, "dropped": torch.zeros_like(rab),
             "shifted": torch.roll(rab, 1, dims=1),
             "clamped": torch.cat([rab[:, :64],
                                   rab[:, 63:64].expand(-1, 64)], dim=1)}
    out = TFB.fused_hstu_block_plain(x, dict(ops, rab=wrong[fault]), tt, 1)
    ok, _, _ = chip_smoke.compare(out, ref, torch.bfloat16)
    assert ok == (fault == "none")
