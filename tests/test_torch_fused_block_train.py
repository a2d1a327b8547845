"""The port's fused HSTU block in training (tencent_recommendation_2025_tpu_
torch/ops/fused_block.py): FusedBlockFn's gradients against jax.grad of the
JAX package's fused Pallas kernel in interpret mode, the plain backward
against autograd of the plain forward, and the dropout masks that the CUDA
kernels share with the plain versions. The kernels themselves are checked
against the plain versions on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py)."""

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


def _setup(B, L, D, H, seed):
    """JAX block params with every LN, bias and rab leaf perturbed off its
    init, seeded inputs and output cotangent, row 0 left-padded."""
    cfg = ModelConfig(hidden_units=D, num_heads=H, block_type="hstu",
                      ffn_type="swiglu", dtype="float32", dropout_rate=0.0,
                      reference_init=False)
    rng = np.random.default_rng(seed)
    params = JENC.init_block_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale", "rab") else a, params)
    x = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    tt = np.ones((B, L), np.int32)
    tt[0, :19] = 0
    cot = rng.standard_normal((B, L, D)).astype(np.float32)
    return params, x, tt, cot


def _leaves(params, grad=True):
    """The port's block tree from JAX params, leaves taking gradients."""
    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        return t.requires_grad_(grad)

    return req(params_from_jax(jax.tree.map(np.asarray, params)))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_grads(bp, x, tt, cot, H, dtype=torch.float32, seed=0, rate=0.0,
                train=False):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = TFB.fused_hstu_block_autograd(xt, bp, torch.from_numpy(tt), seed,
                                        H, rate, train)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, xt.grad


@pytest.mark.parametrize("B,L,D,H", [(1, 256, 16, 2), (1, 256, 64, 1)])
def test_gradients_match_jax_fused_kernel(B, L, D, H):
    params, x, tt, cot = _setup(B, L, D, H, seed=5)

    def f(x, p):
        out = JFB.fused_hstu_block(x, p, jnp.asarray(tt), jnp.int32(0), H,
                                   interpret=True)
        return (out * cot).sum()

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    bp = _leaves(params)
    _, dx = _port_grads(bp, x, tt, cot, H)
    # the tolerances of tests/test_fused_block.py's gradient check
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-5, err_msg="dx")
    flat = jax.tree_util.tree_leaves_with_path(gp)
    assert len(flat) == len(TFB.BLOCK_LEAVES)
    for path, ref in flat:
        leaf = _get(bp, [k.key for k in path])
        assert leaf.grad.dtype == torch.float32
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _autograd_of_plain(bp, x, tt, cot, H, dtype, seed, rate):
    """Gradients of the plain training forward by autograd (operands built
    from the leaves inside the graph)."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ops = TFB.block_operands(bp, dtype)
    out, _ = TFB.fused_hstu_block_train_plain(xt, ops, torch.from_numpy(tt),
                                              H, seed, rate)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, xt.grad


def _compare_to_autograd(dtype, seed, rate, B=2, L=256, D=32, H=2):
    params, x, tt, cot = _setup(B, L, D, H, seed=7)
    a, b = _leaves(params), _leaves(params)
    out_a, dx_a = _port_grads(a, x, tt, cot, H, dtype, seed, rate, True)
    out_b, dx_b = _autograd_of_plain(b, x, tt, cot, H, dtype, seed, rate)
    assert torch.equal(out_a, out_b)
    pairs = [("dx", dx_a, dx_b)] + [
        ("/".join(p), _get(a, p).grad, _get(b, p).grad)
        for p in TFB.BLOCK_LEAVES]
    return pairs


def _bf16_step(t):
    """Spacing of bf16 numbers at the magnitude of max|t|."""
    m = t.abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_backward_matches_autograd_f32(rate):
    """The op-by-op plain backward (what the kernel computes) against
    autograd of the plain forward; with dropout on, this also holds that
    the forward's and the backward's masks agree."""
    for name, got, ref in _compare_to_autograd(torch.float32, 11, rate):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")


def test_plain_backward_matches_autograd_bf16():
    """In bf16 the two round at different points: autograd rounds every
    gradient that crosses a cast, the backward only its product operands,
    and the difference then sums over every token. Measured: up to 1.2 bf16
    steps of a gradient's largest magnitude (ffn/w2), cosine above 0.99998;
    held at two steps and cosine 0.9999."""
    for name, got, ref in _compare_to_autograd(torch.bfloat16, 11, 0.0):
        g, r = got.float(), ref.float()
        err = (g - r).abs().max().item()
        assert err <= 2 * _bf16_step(r), (name, err)
        cos = torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(),
                                                    dim=0).item()
        assert cos >= 0.9999, (name, cos)


def test_bf16_operands_return_unrounded_f32_gradients():
    """With bf16 activations the f32 leaves receive the backward's f32 sums
    (the JAX custom VJP's behaviour), not bf16-rounded gradients."""
    params, x, tt, cot = _setup(1, 256, 32, 2, seed=3)
    bp = _leaves(params)
    _port_grads(bp, x, tt, cot, 2, dtype=torch.bfloat16)
    g = bp["hstu"]["uvqk"]["w"].grad
    assert g.dtype == torch.float32
    assert not torch.equal(g, g.to(torch.bfloat16).float())
    ops = TFB.block_operands(bp, torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _, av = TFB.fused_hstu_block_train_plain(xb, ops, torch.from_numpy(tt),
                                             2, 0, 0.0)
    ref = TFB.fused_hstu_block_bwd_plain(
        xb, av, torch.from_numpy(cot).to(torch.bfloat16), ops,
        torch.from_numpy(tt), 2, 0, 0.0)
    assert torch.equal(g, ref["wuvqk"])


def _numpy_bits(seed, stream, counter):
    """The dropout hash as numpy uint32 arithmetic: the spec the CUDA
    kernels (csrc/fused_block_common.cuh) are held to on the card."""
    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    with np.errstate(over="ignore"):
        key = fmix(np.uint32(seed) + np.uint32(0x9E3779B9)
                   * stream.astype(np.uint32))
        return fmix(key ^ fmix(counter.astype(np.uint32)))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 2])
def test_dropout_bits_match_numpy_spec(seed):
    stream = np.arange(8)[:, None]
    counter = np.arange(0, 1 << 20, 997)[None, :]
    got = TFB.dropout_bits(torch.tensor(seed), torch.from_numpy(stream),
                           torch.from_numpy(counter)).numpy()
    np.testing.assert_array_equal(got, _numpy_bits(seed, stream, counter)
                                  .astype(np.int64))


def test_dropout_determinism_rate_and_eval():
    B, L, D, H = 2, 256, 32, 2
    params, x, tt, _ = _setup(B, L, D, H, seed=13)
    ops = TFB.block_operands(_leaves(params, grad=False), torch.float32)
    xt, ttt = torch.from_numpy(x), torch.from_numpy(tt)

    def run(seed, rate):
        return TFB.fused_hstu_block_train(xt, ops, ttt, H, seed, rate)[0]

    np.testing.assert_array_equal(run(42, 0.5).numpy(), run(42, 0.5).numpy())
    assert not torch.allclose(run(42, 0.5), run(43, 0.5))
    # keep rate of both sites over B * L * (D + F) elements
    F = ops["w2"].shape[0]
    kept = sum(float((TFB.keep_mask(B, L, W, 42, site, 0.5, "cpu") > 0)
                     .sum()) for site, W in ((0, D), (1, F)))
    assert abs(kept / (B * L * (D + F)) - 0.5) < 0.005
    # train=False ignores the rate
    bp = _leaves(params, grad=False)
    with torch.no_grad():
        off = TFB.fused_hstu_block_autograd(xt, bp, ttt, 42, H, 0.5, False)
    np.testing.assert_array_equal(off.numpy(), run(42, 0.0).numpy())
    np.testing.assert_array_equal(
        run(42, 0.0).numpy(), TFB.fused_hstu_block(xt, ops, ttt, H).numpy())
