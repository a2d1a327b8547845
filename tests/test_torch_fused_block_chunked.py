"""The port's fused HSTU block in its chunked variant (L > wholeseq_max_l(D),
tencent_recommendation_2025_tpu_torch/ops/fused_block.py) against the JAX
package's chunked Pallas kernels in interpret mode on the CPU.

As tests/test_fused_block.py does for the JAX package, the whole-sequence
ceiling, the chunk width and the chunked ceiling shrink on both sides
(FB_WHOLESEQ_MAX=256, FB_CHUNK=256, MAX_CHUNKED_L=1024; the JAX attention
tile FB_ATTN_BLK=128 has no counterpart in the port and does not change the
math), so L=512 runs the JAX package's multi-chunk, multi-tile schedule at
test size. The CUDA kernels are held to these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import ModelConfig as JConfig
from tencent_recommendation_2025_tpu.models import encoder as JENC
from tencent_recommendation_2025_tpu.ops import fused_block as JFB
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.config import ModelConfig
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.ops import fused_block as TFB
from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as THA

torch.set_num_threads(2)


@pytest.fixture
def small_chunk(monkeypatch):
    for mod in (JFB, TFB):
        monkeypatch.setattr(mod, "FB_WHOLESEQ_MAX", 256)
        monkeypatch.setattr(mod, "FB_CHUNK", 256)
        monkeypatch.setattr(mod, "MAX_CHUNKED_L", 1024)
    monkeypatch.setattr(JFB, "FB_ATTN_BLK", 128)


def _setup(B, L, D, H, seed):
    """JAX block params with every leaf perturbed off its init, seeded
    inputs and output cotangent; row 0 left-padded and, for B > 1, the last
    row fully padded."""
    cfg = JConfig(hidden_units=D, num_heads=H, block_type="hstu",
                  ffn_type="swiglu", dtype="float32", dropout_rate=0.0,
                  reference_init=False)
    rng = np.random.default_rng(seed)
    params = JENC.init_block_params(jax.random.key(seed), cfg)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                  a.dtype), params)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    tt = np.ones((B, L), np.int32)
    tt[0, :L // 3 + 5] = 0
    if B > 1:
        tt[-1] = 0
    cot = rng.standard_normal((B, L, D)).astype(np.float32)
    return params, x, tt, cot


def _jax_out(params, x, tt, H, dtype=jnp.float32):
    return JFB.fused_hstu_block(jnp.asarray(x, dtype), params,
                                jnp.asarray(tt), jnp.int32(0), H,
                                interpret=True)


def _leaves(params, grad=True):
    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        return t.requires_grad_(grad)

    return req(params_from_jax(jax.tree.map(np.asarray, params)))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_variant_follows_the_shrunk_ceiling(small_chunk):
    assert TFB.chunked(512, 16) and TFB.chunked(512, 64)
    assert not TFB.chunked(256, 64)
    assert TFB.chunked(256, 128)     # wholeseq_max_l(128) = 128 here
    cfg = ModelConfig(hidden_units=16, num_heads=2, block_type="hstu",
                      ffn_type="swiglu")
    assert TFB.fused_block_supported(cfg, 512, "cuda")
    assert not TFB.fused_block_supported(cfg, 1152, "cuda")


@pytest.mark.parametrize("B,L,D,H", [(2, 512, 16, 2), (1, 512, 64, 1)])
def test_chunked_forward_matches_jax(small_chunk, B, L, D, H):
    params, x, tt, _ = _setup(B, L, D, H, seed=3)
    ref = np.asarray(_jax_out(params, x, tt, H))
    ops = TFB.block_operands(_leaves(params, grad=False), torch.float32)
    xt, ttt = torch.from_numpy(x), torch.from_numpy(tt)
    out = TFB.fused_hstu_block(xt, ops, ttt, H).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    # the training forward without dropout computes the same block
    out_t, av = TFB.fused_hstu_block_train(xt, ops, ttt, H, 0, 0.0)
    np.testing.assert_array_equal(out_t.numpy(), out)
    assert av.shape == xt.shape and av.dtype == xt.dtype


def _port_grads_autograd(bp, x, tt, cot, H):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TFB.fused_hstu_block_autograd(xt, bp, torch.from_numpy(tt), 0, H)
    (out * torch.from_numpy(cot)).sum().backward()
    return xt.grad, {p: _get(bp, p).grad for p in TFB.BLOCK_LEAVES}


def _port_grads_plain(bp, x, tt, cot, H):
    """The plain backward called directly on the plain forward's av, its
    outputs mapped onto the leaves as FusedBlockFn.backward maps them."""
    ops = TFB.block_operands(bp, torch.float32)
    xt, ttt = torch.from_numpy(x), torch.from_numpy(tt)
    with torch.no_grad():
        _, av = TFB.fused_hstu_block_train_plain(xt, ops, ttt, H, 0, 0.0)
        g = TFB.fused_hstu_block_bwd_plain(xt, av, torch.from_numpy(cot),
                                           ops, ttt, H, 0, 0.0)
    grads = list(g["ln"]) + [g[k] for k in ("wuvqk", "buvqk", "wo", "bo",
                                            "w13", "w2", "rab")]
    return g["dx"], dict(zip(TFB.BLOCK_LEAVES, grads))


@pytest.mark.parametrize("route", ["autograd", "plain"])
def test_chunked_gradients_match_jax(small_chunk, route):
    B, L, D, H = 1, 512, 16, 2
    params, x, tt, cot = _setup(B, L, D, H, seed=5)

    def f(x, p):
        out = JFB.fused_hstu_block(x, p, jnp.asarray(tt), jnp.int32(0), H,
                                   interpret=True)
        return (out * cot).sum()

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    port = _port_grads_autograd if route == "autograd" else _port_grads_plain
    dx, leaves = port(_leaves(params), x, tt, cot, H)
    # the tolerances of tests/test_fused_block.py's chunked gradient check
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-5, err_msg="dx")
    flat = jax.tree_util.tree_leaves_with_path(gp)
    assert len(flat) == len(TFB.BLOCK_LEAVES)
    for path, ref in flat:
        got = leaves[tuple(k.key for k in path)]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _bf16_mismatch(monkeypatch, params, x, tt, H, port_ceiling):
    """Share of output elements where the port's plain bf16 forward, with
    its whole-sequence ceiling at ``port_ceiling``, differs from the JAX
    chunked kernels' bf16 output, and the largest difference."""
    ref = np.asarray(_jax_out(params, x, tt, H, jnp.bfloat16)
                     .astype(jnp.float32))
    monkeypatch.setattr(TFB, "FB_WHOLESEQ_MAX", port_ceiling)
    ops = TFB.block_operands(_leaves(params, grad=False), torch.bfloat16)
    out = TFB.fused_hstu_block(torch.from_numpy(x).to(torch.bfloat16), ops,
                               torch.from_numpy(tt), H).float().numpy()
    diff = np.abs(out - ref)
    return float((diff > 0).mean()), float(diff.max())


def test_bf16_rounding_point_of_the_chunked_variant(small_chunk, monkeypatch):
    """In bf16 the chunked variant's LN2 reads T(av), the whole-sequence
    variant the f32 sum; in f32 the two agree, so only bf16 can tell them
    apart. Against the JAX chunked kernels in bf16 at this shape (B=2,
    L=512, D=16, H=2, seed 9), measured: the port's chunked variant differs
    in 0.018% of the output elements (largest 0.0039, single bf16 flips from
    summation order); the whole-sequence variant, i.e. the port with the
    rounding point dropped, in 13.3% (largest 0.0156). Held at 1%: the first
    passes, the second fails."""
    params, x, tt, _ = _setup(2, 512, 16, 2, seed=9)
    frac_c, err_c = _bf16_mismatch(monkeypatch, params, x, tt, 2, 256)
    frac_w, err_w = _bf16_mismatch(monkeypatch, params, x, tt, 2, 1024)
    assert frac_c <= 0.01, (frac_c, err_c)
    assert frac_w > 0.01, (frac_w, err_w)


# ---------------------------------------------------------------------------
# encoder level
# ---------------------------------------------------------------------------

def _encoder_setup(B, L, D, H, blocks, seed):
    kw = dict(hidden_units=D, num_heads=H, num_blocks=blocks, maxlen=L - 1,
              block_type="hstu", ffn_type="swiglu", dtype="float32",
              dropout_rate=0.0, reference_init=False)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(seed)
    params = JENC.init_encoder_params(jax.random.key(seed), jcfg)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                  a.dtype), params)
    fe = (rng.standard_normal((B, L, D)) * 0.3).astype(np.float32)
    tt = rng.integers(1, 3, (B, L)).astype(np.int32)
    tt[0, :L // 3] = 0
    seq = np.where(tt > 0, rng.integers(1, 50, (B, L)), 0).astype(np.int32)
    pos = (rng.standard_normal((2 * (L - 1) + 1, D)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((B, L, D)).astype(np.float32)
    return jcfg, tcfg, params, fe, seq, tt, pos, cot


@pytest.fixture
def jax_fused_gate(monkeypatch):
    """The JAX encoder's fused gate opened on the CPU: it then runs the
    fused kernels in interpret mode (encoder._fb_interpret)."""
    monkeypatch.setattr(JFB, "fused_block_supported",
                        lambda cfg, L, backend: True)


def test_encoder_chunked_inference_matches_jax(small_chunk, jax_fused_gate):
    jcfg, tcfg, params, fe, seq, tt, pos, _ = _encoder_setup(
        2, 512, 16, 2, 2, seed=17)
    ref = np.asarray(JENC.encode(params, jnp.asarray(fe), jnp.asarray(seq),
                                 jnp.asarray(tt), jnp.asarray(pos), jcfg))
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        out = TENC.encode(tp, torch.from_numpy(fe), torch.from_numpy(seq),
                          torch.from_numpy(tt), torch.from_numpy(pos), tcfg,
                          route="fused").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=2e-5)


def test_encoder_chunked_gradients_match_jax(small_chunk, jax_fused_gate):
    jcfg, tcfg, params, fe, seq, tt, pos, cot = _encoder_setup(
        1, 512, 16, 2, 2, seed=19)

    def f(fe, params, pos):
        out = JENC.encode(params, fe, jnp.asarray(seq), jnp.asarray(tt), pos,
                          jcfg)
        return (out * cot).sum()

    gfe, gp, gpos = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(fe), params, jnp.asarray(pos))
    tp = _leaves(params)
    fet = torch.from_numpy(fe).requires_grad_(True)
    post = torch.from_numpy(pos).requires_grad_(True)
    out = TENC.encode(tp, fet, torch.from_numpy(seq), torch.from_numpy(tt),
                      post, tcfg, route="fused")
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(fet.grad.numpy(), np.asarray(gfe), rtol=2e-4,
                               atol=2e-5, err_msg="fused_emb")
    np.testing.assert_allclose(post.grad.numpy(), np.asarray(gpos),
                               rtol=2e-4, atol=2e-5, err_msg="pos_table")
    flat = jax.tree_util.tree_leaves_with_path(gp)
    assert flat
    for path, ref in flat:
        got = _get(tp, [k.key for k in path]).grad
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the gate on the card
# ---------------------------------------------------------------------------

def test_block_route_takes_the_chunked_variant_on_the_card():
    """At the real ceilings: every L in (1024, 16384] with L % 128 == 0
    takes the fused kernels at D=64 on the card, in the chunked variant,
    wherever the JAX package takes its chunked kernels on the TPU; so do the
    wider models' chunked ranges. Past the chunked ceiling the JAX package
    takes its chunked standalone HSTU attention, and so does the port (the
    core route); on the CPU every shape runs plain."""
    cfg = ModelConfig(hidden_units=64, num_heads=1, block_type="hstu",
                      ffn_type="swiglu")
    jcfg = JConfig(hidden_units=64, num_heads=1, block_type="hstu",
                   ffn_type="swiglu")
    for L in (2048, 4096, 16384):
        assert TENC.block_route(cfg, L, "cuda") == "fused"
        assert TFB.chunked(L, 64)
    for L in range(1152, 16384 + 1, 128):
        assert TENC.block_route(cfg, L, "cuda") == "fused", L
        assert JFB.fused_block_supported(jcfg, L, "tpu"), L
        assert TENC.block_route(cfg, L, "cpu") == "dense"
    assert not TFB.chunked(1024, 64)
    # past the chunked ceiling the JAX package takes its standalone HSTU
    # attention kernels (chunked), as the port does
    assert not JFB.fused_block_supported(jcfg, 16384 + 128, "tpu")
    assert TENC.block_route(cfg, 16384 + 128, "cuda") == "core"
    for D, L in ((128, 640), (128, 1024), (256, 384), (256, 512)):
        c = dataclasses.replace(cfg, hidden_units=D)
        assert TENC.block_route(c, L, "cuda") == "fused", (D, L)
        assert TFB.chunked(L, D), (D, L)
        assert JFB.fused_block_supported(
            dataclasses.replace(jcfg, hidden_units=D), L, "tpu"), (D, L)
    relu = dataclasses.replace(cfg, ffn_type="relu")
    assert TENC.block_route(relu, 4096, "cuda") == "core"
    # D=512 in one head: the core route, whose kernels take the head of
    # 512 (the JAX package runs its Pallas kernels there too)
    wide = dataclasses.replace(cfg, hidden_units=512)
    assert TENC.block_route(wide, 2048, "cuda") == "core"
    assert not JFB.fused_block_supported(
        dataclasses.replace(jcfg, hidden_units=512), 2048, "tpu")
    THA.check_attention_inputs("k", 1, torch.zeros((1, 2048, 512)))
