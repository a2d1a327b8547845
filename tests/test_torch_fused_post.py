"""The plain versions the fused block's wgmma post half and gate/FFN
backward are held to on the card (``attn_ffn_wgmma_kernel``,
``gate_ffn_bwd_wgmma_kernel`` + ``wgrad_wgmma_kernel``, ``chip_smoke.py``
and ``tests/test_torch_kernels_gpu.py``): ``ring_post_fwd_plain`` and
``ring_post_bwd_plain`` of ``ops/fused_block.py``, against the JAX
package's stage kernels through ``ring_post_gate`` (its forward runs
``_fwd_post_kernel_chunk``, its VJP ``_bwd_gate_kernel_chunk``), in
interpret mode on the CPU.

Inputs come from numpy with a seed, parameters through
``bridge.params_from_jax``; f32, dropout 0; H in {1, 2, 4} and hd in {8,
16, 32} (D = H * hd); row 0 left-padded, its padded queries with av = 0
(no visible key), so LN2 normalises a zero row. Tolerances are those of
``tests/test_fused_block.py``: rtol 1e-4 / atol 1e-5 for values, 2e-4 /
2e-5 for gradients. LN2's backward multiplies dav by 1/sqrt(var + eps) of
its row of av in both versions (20 at av's scale of 0.05, 1e4 on a zero
row), which scales f32 rounding by as much: dav is compared in LN2's
normalised scale, times its row's sqrt(var + eps), at the same rtol and
atol. The weight, LN and bias gradients are sums over every token of the
shard (up to 135 in size here), taken in another order: their atol is
2e-5 * max(1, max|ref|), the rule of tests/test_torch_kernels_gpu.py's
_close for such sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import ModelConfig as JConfig
from tencent_recommendation_2025_tpu.models import encoder as JENC
from tencent_recommendation_2025_tpu.ops import fused_block as JFB
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.ops import fused_block as TFB

torch.set_num_threads(2)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
B, LC, PAD = 2, 256, 37
SHAPES = [(H, hd) for H in (1, 2, 4) for hd in (8, 16, 32)]


def _t(a):
    """[B, D, L] JAX array -> [B, L, D] numpy."""
    return np.swapaxes(np.asarray(a), 1, 2)


def _tj(a):
    """[B, L, D] numpy -> [B, D, L] JAX array."""
    return jnp.asarray(np.swapaxes(a, 1, 2))


def _setup(H, hd, seed):
    """One block of width D = H * hd with every leaf off its init (both
    packages), the shard's x, av (0 on row 0's padded queries), the
    output cotangent, the port's operands and u."""
    D = H * hd
    cfg = JConfig(hidden_units=D, num_heads=H, block_type="hstu",
                  ffn_type="swiglu", dtype="float32", dropout_rate=0.0,
                  reference_init=False)
    rng = np.random.default_rng(seed)
    jbp = JENC.init_block_params(jax.random.key(seed), cfg)
    jbp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jbp)
    bp = params_from_jax(jax.tree.map(np.asarray, jbp))
    x = (rng.standard_normal((B, LC, D)) * 0.5).astype(np.float32)
    av = (rng.standard_normal((B, LC, D)) * 0.05).astype(np.float32)
    av[0, :PAD] = 0.0
    cot = rng.standard_normal((B, LC, D)).astype(np.float32)
    ops = TFB.block_operands(bp, torch.float32)
    with torch.no_grad():
        u = TFB.ring_pre_fwd_plain(torch.from_numpy(x), ops, 2 * LC, H)[3]
    return jbp, x, av, cot, ops, u


def _jax_post(jbp, H, L):
    _, lnt, wuvqk, buvqkt, wo, bot, w13, w2 = JFB._block_operands(
        jbp, jnp.float32)

    def f(xt, avt, ut):
        return JFB.ring_post_gate(xt, avt, ut, lnt, wuvqk, buvqkt, wo, bot,
                                  w13, w2, jnp.int32(0), L, H, 0.0, False,
                                  True)

    return f, (lnt, wo, bot, w13, w2)


@pytest.mark.parametrize("H,hd", SHAPES)
def test_post_forward_plain_matches_jax_stage_kernel(H, hd):
    """ring_post_fwd_plain (the card's attn_ffn_wgmma_kernel post half and
    stage 1) against _fwd_post_kernel_chunk."""
    jbp, x, av, _, ops, u = _setup(H, hd, seed=100 + 10 * H + hd)
    f, _ = _jax_post(jbp, H, 2 * LC)
    jout = f(_tj(x), _tj(av), _tj(u.numpy()))
    with torch.no_grad():
        out = TFB.ring_post_fwd_plain(torch.from_numpy(x),
                                      torch.from_numpy(av), u, ops, 0, 0.0)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _t(jout), **FWD)


@pytest.mark.parametrize("H,hd", SHAPES)
def test_post_backward_plain_matches_jax_stage_kernel(H, hd):
    """ring_post_bwd_plain (the card's gate_ffn_bwd_wgmma_kernel and
    wgrad_wgmma_kernel, whole-sequence, chunked and stage 0) against
    _bwd_gate_kernel_chunk: dav, du, the residual path's dx, the LN2 and
    LN3 gradients, dWo, dbo, dW13 and dW2."""
    jbp, x, av, cot, ops, u = _setup(H, hd, seed=200 + 10 * H + hd)
    L = 2 * LC
    f, (lnt, wo, bot, w13, w2) = _jax_post(jbp, H, L)
    _, lnt, wuvqk, buvqkt, wo, bot, w13, w2 = JFB._block_operands(
        jbp, jnp.float32)

    def g(xt, avt, ut, lnt, wo, bot, w13, w2):
        return JFB.ring_post_gate(xt, avt, ut, lnt, wuvqk, buvqkt, wo, bot,
                                  w13, w2, jnp.int32(0), L, H, 0.0, False,
                                  True)

    _, vjp = jax.vjp(g, _tj(x), _tj(av), _tj(u.numpy()), lnt, wo, bot, w13,
                     w2)
    jdx, jdav, jdu, jdln, jdwo, jdbo, jdw13, jdw2 = vjp(_tj(cot))
    with torch.no_grad():
        got = TFB.ring_post_bwd_plain(torch.from_numpy(x),
                                      torch.from_numpy(av),
                                      torch.from_numpy(cot), ops, 0, 0.0, L,
                                      H)
    jdln = np.asarray(jdln)
    want = {"dy": _t(jdx), "dav": _t(jdav), "du": _t(jdu),
            "ln": jdln.T, "wo": np.asarray(jdwo),
            "bo": np.asarray(jdbo)[:, 0], "w13": np.asarray(jdw13),
            "w2": np.asarray(jdw2)}
    assert set(got) == set(want)
    assert not got["ln"][:2].any()      # the pre stage owns LN1's rows
    got = {n: t.float().numpy() for n, t in got.items()}
    std = np.sqrt(av.astype(np.float64).var(-1, keepdims=True) + 1e-8)
    got["dav"], want["dav"] = got["dav"] * std, want["dav"] * std
    for name, ref in want.items():
        atol = GRAD["atol"]
        if name in ("ln", "wo", "bo", "w13", "w2"):   # sums over tokens
            atol *= max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got[name], ref, rtol=GRAD["rtol"],
                                   atol=atol, err_msg=name)
