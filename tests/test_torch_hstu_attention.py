"""The port's standalone HSTU attention (tencent_recommendation_2025_tpu_torch/
ops/hstu_attention.py) against the JAX package's Pallas kernels run in
interpret mode on the CPU: the plain versions of the forward and backward
kernels (which a CPU tensor takes) through the port's autograd Function,
including the rel-pos gradient, which the JAX package folds back from its
bias-tile gradients with ``_bias_tiles_transpose``. The CUDA kernels are
held to these plain versions on the card (chip_smoke.py,
tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.ops import hstu_attention as JHA
from tencent_recommendation_2025_tpu_torch.config import PRESETS
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as THA

torch.set_num_threads(2)

PAD = 19


def _inputs(B=3, L=256, D=32, H=2, buckets=128, seed=0):
    """Post-SiLU-like q, k, v and a cotangent [B, L, D], rab [H, buckets],
    and the key-valid mask: row 0 left-padded, the last row fully
    padded."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, L, D)).astype(np.float32)
                   for _ in range(4))
    rab = (rng.standard_normal((H, buckets)) * 0.1).astype(np.float32)
    valid = np.ones((B, L), bool)
    valid[0, :PAD] = False
    valid[-1] = False
    return q, k, v, do, rab, valid


def _jax(q, k, v, do, rab, valid, H, dtype=jnp.float32):
    L = q.shape[1]
    args = [jnp.asarray(t, dtype) for t in (q, k, v)] + [jnp.asarray(rab)]

    def f(q, k, v, rab):
        return JHA.hstu_attention_packed(q, k, v, jnp.asarray(valid), rab, L,
                                         H, interpret=True)

    out, vjp = jax.vjp(f, *args)
    return out, vjp(jnp.asarray(do, dtype))


def _port(q, k, v, do, rab, valid, H, dtype=torch.float32):
    L = q.shape[1]
    qt, kt, vt = (torch.from_numpy(t).to(dtype).requires_grad_(True)
                  for t in (q, k, v))
    rt = torch.from_numpy(rab).requires_grad_(True)
    out = THA.hstu_attention_packed(qt, kt, vt, torch.from_numpy(valid), rt,
                                    L, H)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach(), (qt.grad, kt.grad, vt.grad, rt.grad)


@pytest.mark.parametrize("buckets", [32, 128, 300])
def test_f32_forward_and_gradients_match_jax(buckets):
    """Forward at rtol 1e-4 / atol 1e-5; dq, dk, dv and drab at 2e-4 / 2e-5.
    Buckets below one tile, one tile, and three near-diagonal slots."""
    q, k, v, do, rab, valid = _inputs(buckets=buckets, seed=buckets)
    ref, rgrads = _jax(q, k, v, do, rab, valid, 2)
    out, grads = _port(q, k, v, do, rab, valid, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, rgrads):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    assert not out[-1].any() and not out[0, :PAD].any()
    for g in grads[:3]:
        assert not g[-1].any() and not g[0, :PAD].any()


def test_bf16_matches_jax_kernel():
    """In bf16 (hstu_mini's 4 heads of 16) the port's plain version keeps
    the JAX kernel's rounding points (q scaled then rounded, a rounded
    before a @ v, ds rounded before its products): max abs error <= 1/128
    of max(1, max|ref|) (one bf16 step) and cosine >= 0.99999 for the
    output, dq, dk, dv and drab (an f32 sum)."""
    q, k, v, do, rab, valid = _inputs(D=64, H=4, seed=5)
    ref, rgrads = _jax(q, k, v, do, rab, valid, 4, jnp.bfloat16)
    out, grads = _port(q, k, v, do, rab, valid, 4, torch.bfloat16)
    for name, got, want in zip(("out", "dq", "dk", "dv", "drab"),
                               (out, *grads), (ref, *rgrads)):
        g = got.float().numpy().astype(np.float64).ravel()
        w = np.asarray(want.astype(jnp.float32)).astype(np.float64).ravel()
        assert np.abs(g - w).max() <= 1 / 128 * max(1.0, np.abs(w).max()), \
            name
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99999, \
            name


def test_chunked_shape_on_the_cpu_matches_jax_chunked_kernels(monkeypatch):
    """Past ``_use_long`` the JAX package takes its chunked kernels (not
    ported); on the CPU the port's plain version computes the same
    function (both ceilings cut to 128 so that L=384 is chunked)."""
    monkeypatch.setattr(JHA, "MAX_WHOLESEQ_L", 128)
    monkeypatch.setattr(THA, "MAX_WHOLESEQ_L", 128)
    assert JHA._use_long(384, 32) and THA._use_long(384, 32)
    q, k, v, do, rab, valid = _inputs(B=2, L=384, buckets=300, seed=9)
    ref, rgrads = _jax(q, k, v, do, rab, valid, 2)
    out, grads = _port(q, k, v, do, rab, valid, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_n_near_error_matches_jax():
    """More buckets than 8 bias-tile slots take: the JAX package's own
    ValueError, raised before any work on every device."""
    assert THA._n_near(7 * 128 + 2) == JHA._n_near(7 * 128 + 2) == 8
    for b in (1, 2, 129, 130, 300):
        assert THA._n_near(b) == JHA._n_near(b)
    with pytest.raises(ValueError) as mine:
        THA._n_near(7 * 128 + 3)
    with pytest.raises(ValueError) as theirs:
        JHA._n_near(7 * 128 + 3)
    assert str(mine.value) == str(theirs.value)
    q, k, v, _, rab, valid = _inputs(buckets=7 * 128 + 3)
    with pytest.raises(ValueError, match="at most 8"):
        THA.hstu_attention_packed(*(torch.from_numpy(t) for t in (q, k, v)),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(rab), 256, 2)


def test_use_long_dispatch_and_the_card_raising_for_it():
    for L in (256, 512, 1024, 2048, 4096):
        for D in (16, 64, 128, 256):
            assert THA._use_long(L, D) == JHA._use_long(L, D), (L, D)
    mini = PRESETS["hstu_mini"]().model
    assert TENC.block_route(mini, 1024, "cuda") == "core"
    with pytest.raises(NotImplementedError, match="rows 15-17"):
        TENC.block_route(mini, 2048, "cuda")
    assert TENC.block_route(mini, 2048, "cpu") == "dense"


def test_oracle_and_head_interface_match_jax():
    q, k, v, _, rab, valid = _inputs(B=2, L=128, D=32, H=2, seed=2)

    def heads(a):
        return a.reshape(2, 128, 2, 16).transpose(0, 2, 1, 3)

    ref = JHA.hstu_attention_oracle(*(jnp.asarray(heads(a)) for a in
                                      (q, k, v)), jnp.asarray(valid),
                                    jnp.asarray(rab), 128)
    got = THA.hstu_attention_oracle(*(torch.from_numpy(heads(a)).contiguous()
                                      for a in (q, k, v)),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(rab), 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    out = THA.hstu_attention(*(torch.from_numpy(heads(a)).contiguous()
                               for a in (q, k, v)), torch.from_numpy(valid),
                             torch.from_numpy(rab), 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    meta = torch.zeros((2, 128, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        THA.hstu_attention_fwd(meta, meta, meta, torch.ones(2, 128),
                               torch.zeros(2, 128), 128, 2)
