"""The plain versions the fused block's wgmma pre half is held to on the card
(``proj_wgmma_kernel`` and ``proj_bwd_wgmma_kernel`` with
``wgrad_wgmma_kernel``, ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py``): ``ring_pre_fwd_plain`` and
``ring_pre_bwd_plain`` of ``ops/fused_block.py``, against the JAX package's
stage kernels through ``ring_pre_proj`` (its forward runs
``_fwd_pre_kernel_chunk``, its VJP ``_bwd_proj_kernel_chunk``), in
interpret mode on the CPU; and the route predicate that picks the wgmma
instances.

Inputs come from numpy with a seed, parameters through
``bridge.params_from_jax``; f32; H in {1, 2, 4} and hd in {8, 16, 32} (D =
H * hd); row 0 left-padded, its padded tokens' x all 0, so LN1 normalises a
zero row. Tolerances are those of ``tests/test_fused_block.py``: rtol 1e-4 /
atol 1e-5 for values, 2e-4 / 2e-5 for gradients. LN1's backward multiplies
dx by 1/sqrt(var + eps) of its row of x in both versions (1e4 on a zero
row), which scales f32 rounding by as much: dx is compared in LN1's
normalised scale, times its row's sqrt(var + eps), at the same rtol and
atol. dWuvqk, dbuvqk and the LN gradients are sums over every token of the
shard, taken in another order: their atol is 2e-5 * max(1, max|ref|), the
rule of tests/test_torch_kernels_gpu.py's _close for such sums."""

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
    packages), the shard's x (0 on row 0's padded tokens), the four output
    cotangents (dq, dk, dv, du) and the port's operands."""
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
    x[0, :PAD] = 0.0
    cots = [rng.standard_normal((B, LC, D)).astype(np.float32)
            for _ in range(4)]
    return jbp, x, cots, TFB.block_operands(bp, torch.float32)


def _jax_pre(jbp, H, L):
    _, lnt, wuvqk, buvqkt, *_ = JFB._block_operands(jbp, jnp.float32)

    def f(xt, lnt, wuvqk, buvqkt):
        return JFB.ring_pre_proj(xt, lnt, wuvqk, buvqkt, L, H, True)

    return f, (lnt, wuvqk, buvqkt)


@pytest.mark.parametrize("H,hd", SHAPES)
def test_pre_forward_plain_matches_jax_stage_kernel(H, hd):
    """ring_pre_fwd_plain (the card's proj_wgmma_kernel: whole-sequence,
    chunked and stage 0) against _fwd_pre_kernel_chunk: q (times hd^-1/2),
    k, v (times 1/L, L the whole sequence's) and u."""
    jbp, x, _, ops = _setup(H, hd, seed=300 + 10 * H + hd)
    L = 2 * LC
    f, params = _jax_pre(jbp, H, L)
    want = f(_tj(x), *params)
    with torch.no_grad():
        got = TFB.ring_pre_fwd_plain(torch.from_numpy(x), ops, L, H)
    for name, g, w in zip(("q", "k", "v", "u"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), _t(w), err_msg=name, **FWD)


def _check_bwd(got, want, x):
    """got: ring_pre_bwd_plain's dict; want: the JAX VJP's (dxt, dlnt,
    dwuvqk, dbuvqkt)."""
    jdx, jdln, jdw, jdb = want
    assert set(got) == {"dx", "ln", "wuvqk", "buvqk"}
    assert not got["ln"][2:].any()     # the post stage owns LN2's and LN3's
    got = {n: t.float().numpy() for n, t in got.items()}
    want = {"dx": _t(jdx), "ln": np.asarray(jdln).T,
            "wuvqk": np.asarray(jdw), "buvqk": np.asarray(jdb)[:, 0]}
    std = np.sqrt(x.astype(np.float64).var(-1, keepdims=True) + 1e-8)
    got["dx"], want["dx"] = got["dx"] * std, want["dx"] * std
    for name, ref in want.items():
        atol = GRAD["atol"]
        if name != "dx":   # sums over tokens
            atol *= max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got[name], ref, rtol=GRAD["rtol"],
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("H,hd", SHAPES)
def test_pre_backward_plain_matches_jax_stage_kernel(H, hd):
    """ring_pre_bwd_plain (the card's proj_bwd_wgmma_kernel and
    wgrad_wgmma_kernel: whole-sequence, chunked and stage 1) against
    _bwd_proj_kernel_chunk: dx (no residual), LN1's gradients, dWuvqk and
    dbuvqk, from f32 cotangents of q (w.r.t. the scaled q), k, v (w.r.t.
    the scaled v) and u."""
    jbp, x, cots, ops = _setup(H, hd, seed=400 + 10 * H + hd)
    L = 2 * LC
    f, params = _jax_pre(jbp, H, L)
    _, vjp = jax.vjp(f, _tj(x), *params)
    want = vjp(tuple(_tj(c) for c in cots))
    with torch.no_grad():
        got = TFB.ring_pre_bwd_plain(torch.from_numpy(x), ops,
                                     *(torch.from_numpy(c) for c in cots),
                                     L, H)
    _check_bwd(got, want, x)


def test_pre_backward_plain_widens_bf16_cotangents_as_jax():
    """The ring passes dq, dk and dv in bf16 (the pairs' backward rounds
    them) and du in f32: the plain version (and the kernel, which reads
    them so) widens each to f32 and multiplies dq by hd^-1/2 in f32 before
    dsilu, as _rpp_bwd's ``dqt.astype(f32) * hd^-1/2`` does. The JAX VJP
    gets the same values in f32; the tolerances are the f32 ones, which a
    scaling rounded to bf16 (a relative error up to 2^-9) would break."""
    H, hd = 1, 32   # hd^-1/2 not a power of 2: its rounding shows
    jbp, x, cots, ops = _setup(H, hd, seed=501)
    L = 2 * LC
    bf = [torch.from_numpy(c).to(torch.bfloat16) for c in cots[:3]]
    du = torch.from_numpy(cots[3])
    f, params = _jax_pre(jbp, H, L)
    _, vjp = jax.vjp(f, _tj(x), *params)
    want = vjp(tuple(_tj(c.float().numpy()) for c in bf) + (_tj(cots[3]),))
    with torch.no_grad():
        got = TFB.ring_pre_bwd_plain(torch.from_numpy(x), ops, *bf, du, L, H)
    _check_bwd(got, want, x)
    # dq scaled by hd^-1/2 in bf16 (rounded there), then widened, fails
    with torch.no_grad():
        early = TFB.ring_pre_bwd_plain(
            torch.from_numpy(x), ops,
            (bf[0] * hd ** -0.5).to(torch.bfloat16) * hd ** 0.5, *bf[1:], du,
            L, H)
    with pytest.raises(AssertionError):
        _check_bwd(early, want, x)


@pytest.mark.parametrize("dtype,D,wgmma", [
    (torch.bfloat16, 32, True), (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True), (torch.bfloat16, 192, False),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False)])
def test_block_wgmma_route(dtype, D, wgmma):
    """bf16 at D <= 128 takes the wgmma instances of the pre and post
    halves (the backward's scratch is passed exactly then); f32, the tight
    check instance, and wider models take the first kernels."""
    assert TFB.block_wgmma(dtype, D) is wgmma
    x = torch.zeros((1, 64, D), dtype=dtype)
    names = set(TFB._wgmma_scratch(x, 4 * D))
    assert names == ({"fs", "dx13s", "h2s", "gs", "dys", "h1s", "duvqks",
                      "psum"} if wgmma else set())
    assert set(TFB._wgmma_scratch(x, 4 * D, gate=False)) == (
        {"h1s", "duvqks", "psum"} if wgmma else set())
