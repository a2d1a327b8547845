"""The fused HSTU block's attention backward on the CPU: the single device's
gradients are the ring's pair of shards at off 0 (one kernel pair on the
card, csrc/hstu_attn_bwd_sm90.cuh, serves both), the plain pair backward is
autograd of the plain pair forward, and the port's whole-block plain
backward matches jax.grad of the JAX package's fused Pallas kernel in
interpret mode. Every case in f32, with row 0 left-padded, the last row
fully padded and fewer rel-pos buckets than tokens (the last bucket
clamps). The kernels themselves are held to these plain versions on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import ModelConfig
from tencent_recommendation_2025_tpu.models import encoder as JENC
from tencent_recommendation_2025_tpu.ops import fused_block as JFB
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.ops import fused_block as TFB

torch.set_num_threads(2)

#: (H, hd, L): every head count and head dim at both lengths
CASES = [(H, hd, L) for H in (1, 2, 4) for hd in (8, 16, 32)
         for L in (256, 384)]


def _setup(H, hd, L, seed, B=2):
    """JAX block params (LN, bias and rab leaves off their init) with L / 4
    rel-pos buckets, and seeded x, token types and output cotangent: row 0
    left-padded, the last row fully padded."""
    D, NB = H * hd, L // 4
    cfg = ModelConfig(hidden_units=D, num_heads=H, block_type="hstu",
                      ffn_type="swiglu", dtype="float32", dropout_rate=0.0,
                      reference_init=False, hstu_rel_pos_buckets=NB)
    rng = np.random.default_rng(seed)
    params = JENC.init_block_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale", "rab") else a, params)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    tt = np.ones((B, L), np.int32)
    tt[0, :L // 3 + 5] = 0
    tt[-1] = 0
    cot = rng.standard_normal((B, L, D)).astype(np.float32)
    return params, x, tt, cot


def _port_params(params):
    return params_from_jax(jax.tree.map(np.asarray, params))


def _close(got, want, what):
    """The gradient tolerance: rtol 2e-4, atol 2e-5 * max(1, max|want|)
    (sums of up to B * L terms in another order)."""
    want = want.float()
    atol = 2e-5 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.float(), want, rtol=2e-4, atol=atol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("H,hd,L", CASES)
def test_single_device_attention_gradients_are_the_pair_at_off_0(H, hd, L):
    """The single device's plain backward against the ring's plain stages
    composed at S = 1: ring_post_bwd, ring_pair_dq (times hd^-1/2, through
    ring_pre_bwd) and ring_pair_dkdv at off 0 with Lq = Lk = L, then
    ring_pre_bwd. The rel-pos gradient is ring_pair_dq's drab; dq, dk and
    dv show in the projection's gradients and dx."""
    params, x, tt, cot = _setup(H, hd, L, seed=H * 100 + hd + L)
    ops = TFB.block_operands(_port_params(params), torch.float32)
    xt, ttt = torch.from_numpy(x), torch.from_numpy(tt)
    dout = torch.from_numpy(cot)
    _, av = TFB.fused_hstu_block_train_plain(xt, ops, ttt, H, 0, 0.0)
    single = TFB.fused_hstu_block_bwd_plain(xt, av, dout, ops, ttt, H, 0,
                                            0.0)

    post = TFB.ring_post_bwd_plain(xt, av, dout, ops, 0, 0.0, L, H)
    q, k, v, _ = TFB.ring_pre_fwd_plain(xt, ops, L, H)
    dq, drab = TFB.ring_pair_dq_plain(q, k, v, post["dav"], ttt, ops["rab"],
                                      0, H)
    dk, dv = TFB.ring_pair_dkdv_plain(q, k, v, post["dav"], ttt, ops["rab"],
                                      0, H)
    pre = TFB.ring_pre_bwd_plain(xt, ops, dq, dk, dv, post["du"], L, H)
    _close(single["rab"], drab, "rab")
    assert drab[:, -1].abs().sum() > 0   # the clamped bucket is reached
    for name in ("wuvqk", "buvqk"):
        _close(single[name], pre[name], name)
    _close(single["ln"], pre["ln"] + post["ln"], "ln")
    _close(single["dx"], post["dy"] + pre["dx"], "dx")


@pytest.mark.parametrize("H,hd,L", CASES)
def test_pair_backward_plain_is_autograd_of_the_pair_forward(H, hd, L):
    """The reference both kernels are held to: ring_pair_dq_plain and
    ring_pair_dkdv_plain at off 0 (and ring_pair_bwd_plain, which the
    single device's plain backward calls) against torch.autograd of
    ring_pair_fwd_plain with the same cotangent, in f32 where a and ds
    round nowhere."""
    rng = np.random.default_rng(H * 1000 + hd * 10 + L)
    B, D, NB = 2, H * hd, L // 4

    def t(shape, s=0.5):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32))

    q, k, v, dav = t((B, L, D)), t((B, L, D)), t((B, L, D)), t((B, L, D), 1)
    rab = t((H, NB), 0.1)
    valid = torch.ones((B, L), dtype=torch.int32)
    valid[0, :L // 3 + 5] = 0
    valid[-1] = 0
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v, rab)]
    out = TFB.ring_pair_fwd_plain(leaves[0], leaves[1], leaves[2], valid,
                                  leaves[3], 0, H)
    (out * dav).sum().backward()
    want = dict(zip(("dq", "dk", "dv", "drab"), (a.grad for a in leaves)))

    dq, drab = TFB.ring_pair_dq_plain(q, k, v, dav, valid, rab, 0, H)
    dk, dv = TFB.ring_pair_dkdv_plain(q, k, v, dav, valid, rab, 0, H)
    both = TFB.ring_pair_bwd_plain(q, k, v, dav, valid, rab, 0, H)
    for name, got, once in zip(("dq", "drab", "dk", "dv"),
                               (dq, drab, dk, dv), both):
        _close(got, want[name], name)
        assert torch.equal(once, got), name
    # the fully padded row has no visible key: its keys get no gradient
    assert not dk[-1].any() and not dv[-1].any() and not dq[-1].any()


@pytest.mark.parametrize("H,hd,L", CASES)
def test_whole_block_plain_backward_matches_jax_fused_kernel(H, hd, L):
    """The port's whole-block plain backward (FusedBlockFn on CPU tensors)
    against jax.grad of the JAX package's fused Pallas kernel, run in
    interpret mode as tests/test_fused_block.py runs it; the tolerances of
    that file's gradient check."""
    params, x, tt, cot = _setup(H, hd, L, seed=H * 100 + hd + L)

    def f(x, p):
        out = JFB.fused_hstu_block(x, p, jnp.asarray(tt), jnp.int32(0), H,
                                   interpret=True)
        return (out * cot).sum()

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)

    def req(tree):
        if isinstance(tree, dict):
            return {key: req(val) for key, val in tree.items()}
        return tree.requires_grad_(True)

    bp = req(_port_params(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TFB.fused_hstu_block_autograd(xt, bp, torch.from_numpy(tt), 0, H)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-5, err_msg="dx")
    flat = jax.tree_util.tree_leaves_with_path(gp)
    assert len(flat) == len(TFB.BLOCK_LEAVES)
    for path, ref in flat:
        leaf = bp
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))
