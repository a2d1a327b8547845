"""The standalone HSTU attention's in-kernel SiLU (``silu_qkv=True``:
pre-activation q, k, v) in the port (tencent_recommendation_2025_tpu_torch/
ops/hstu_attention.py: the plain versions a CPU tensor takes, which the
CUDA kernels are held to on the card) against the JAX package's Pallas
kernels with ``silu_qkv=True`` in interpret mode: the forward and the
gradients with respect to the pre-activations and ``rab``; the
whole-sequence route at L=256 (f32 at rtol 1e-4 / atol 1e-5, gradients at
2e-4 / 2e-5; bf16 at tests/test_torch_hstu_attention.py's bf16 limits) and
the chunked one at L=512 (``MAX_WHOLESEQ_L`` cut to 256 in both packages,
as tests/test_hstu_kernel.py cuts it), hd 8, 64 and 128; and the
``fused_silu`` hook of models/hstu.py: one HSTU block whose core applies
the SiLU itself, against the JAX ``hstu_block`` with such a core (forward
and every gradient). B=1 and H <= 2 keep the interpret-mode kernels
short."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.models import hstu as JH
from tencent_recommendation_2025_tpu.ops import hstu_attention as JHA
from tencent_recommendation_2025_tpu_torch.models import hstu as TH
from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as THA

torch.set_num_threads(2)


def _inputs(L, D, H, seed):
    """Pre-activation q, k, v and a cotangent [1, L, D], rab [H, 128], and
    the key-valid mask with the first 19 keys padded."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((1, L, D)).astype(np.float32) * 1.5
                   for _ in range(4))
    rab = (rng.standard_normal((H, 128)) * 0.1).astype(np.float32)
    valid = np.ones((1, L), bool)
    valid[0, :19] = False
    return q, k, v, do, rab, valid


def _jax(q, k, v, do, rab, valid, H, dtype):
    L = q.shape[1]
    args = [jnp.asarray(t, dtype) for t in (q, k, v)] + [jnp.asarray(rab)]

    def f(q, k, v, rab):
        return JHA.hstu_attention_packed(q, k, v, jnp.asarray(valid), rab, L,
                                         H, interpret=True, silu_qkv=True)

    out, vjp = jax.vjp(f, *args)
    return [out, *vjp(jnp.asarray(do, dtype))]


def _port(q, k, v, do, rab, valid, H, dtype):
    L = q.shape[1]
    qt, kt, vt = (torch.from_numpy(t).to(dtype).requires_grad_(True)
                  for t in (q, k, v))
    rt = torch.from_numpy(rab).requires_grad_(True)
    out = THA.hstu_attention_packed(qt, kt, vt, torch.from_numpy(valid), rt,
                                    L, H, silu_qkv=True)
    out.backward(torch.from_numpy(do).to(dtype))
    return [out.detach(), qt.grad, kt.grad, vt.grad, rt.grad]


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32), np.float32)


def _check_f32(got, want):
    for name, g, w in zip(("out", "dq", "dk", "dv", "drab"), got, want):
        tol = (1e-4, 1e-5) if name == "out" else (2e-4, 2e-5)
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol[0],
                                   atol=tol[1], err_msg=name)


#: (D, H) at hd 8, 64 and 128
HEADS = [(16, 2), (64, 1), (128, 1)]


@pytest.mark.parametrize("D,H", HEADS)
def test_f32_whole_sequence_matches_jax(D, H):
    """L=256 (the whole-sequence kernels): forward and the pre-activations'
    gradients in f32; padded keys' dk and dv exactly 0."""
    q, k, v, do, rab, valid = _inputs(256, D, H, seed=D + H)
    want = _jax(q, k, v, do, rab, valid, H, jnp.float32)
    got = _port(q, k, v, do, rab, valid, H, torch.float32)
    _check_f32(got, want)
    for g in got[2:4]:
        assert not g[0, :19].any()


@pytest.mark.parametrize("D,H", HEADS)
def test_bf16_matches_jax_kernel(D, H):
    """In bf16 the plain version keeps the JAX kernel's rounding points
    (T(silu(q) hd^-1/2) once, T(silu(k)), T(silu(v)); the epilogues' dsilu
    in f32 before dq, dk, dv round): max abs error <= 1/128 of max(1,
    max|ref|) and cosine >= 0.99999, as the bf16 cases of
    tests/test_torch_hstu_attention.py."""
    q, k, v, do, rab, valid = _inputs(256, D, H, seed=3 * D + H)
    want = _jax(q, k, v, do, rab, valid, H, jnp.bfloat16)
    got = _port(q, k, v, do, rab, valid, H, torch.bfloat16)
    for name, g, w in zip(("out", "dq", "dk", "dv", "drab"), got, want):
        g, w = (_f32(t).astype(np.float64).ravel() for t in (g, w))
        assert np.abs(g - w).max() <= 1 / 128 * max(1.0, np.abs(w).max()), \
            name
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99999, \
            name


def test_chunked_route_matches_jax(monkeypatch):
    """L=512 past the cut ``MAX_WHOLESEQ_L`` of 256: the JAX package's
    chunked kernels with ``silu_qkv`` (the port's plain version on the
    CPU, its chunked wrappers on the card), f32, hd 8."""
    monkeypatch.setattr(JHA, "MAX_WHOLESEQ_L", 256)
    monkeypatch.setattr(THA, "MAX_WHOLESEQ_L", 256)
    assert JHA._use_long(512, 16) and THA._use_long(512, 16)
    q, k, v, do, rab, valid = _inputs(512, 16, 2, seed=10)
    _check_f32(_port(q, k, v, do, rab, valid, 2, torch.float32),
               _jax(q, k, v, do, rab, valid, 2, jnp.float32))


def test_silu_qkv_false_is_the_post_silu_kernel():
    """``silu_qkv=True`` on pre-activations equals the default kernel on
    T(silu(.)) of them in f32 (the forward; SiLU outside): the flag only
    moves the activation into the kernel."""
    q, k, v, do, rab, valid = _inputs(256, 32, 2, seed=21)
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    args = (torch.from_numpy(valid), torch.from_numpy(rab), 256, 2)
    fused = THA.hstu_attention_fwd_plain(qt, kt, vt, *args, silu_qkv=True)
    apart = THA.hstu_attention_fwd_plain(*(torch.nn.functional.silu(t)
                                           for t in (qt, kt, vt)), *args)
    np.testing.assert_allclose(fused.numpy(), apart.numpy(), rtol=1e-6,
                               atol=1e-7)


def _block_params(D, H, seed):
    rng = np.random.default_rng(seed)

    def a(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {"uvqk": {"w": a(D, 4 * D), "b": a(4 * D, s=0.1)},
            "out": {"w": a(D, D), "b": a(D, s=0.1)},
            "attn_ln": {"scale": 1.0 + a(D, s=0.1), "bias": a(D, s=0.1)},
            "rab": a(H, 128, s=0.1)}


def test_fused_silu_core_in_an_hstu_block_matches_jax():
    """One HSTU block (L=256, D=32, H=2) whose core carries ``fused_silu``
    (the standalone attention with ``silu_qkv=True`` on the pre-activation
    q, k, v; only u through the SiLU outside) against the JAX
    ``hstu_block`` with the same kind of core: the output and the
    gradients of x and of every parameter, f32 at rtol 2e-4 / atol
    2e-5."""
    L, D, H = 256, 32, 2
    p = _block_params(D, H, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, L, D)).astype(np.float32)
    cot = rng.standard_normal((1, L, D)).astype(np.float32)
    valid = np.ones((1, L), bool)
    valid[0, :19] = False

    def jcore(q, k, v, rab):
        return JHA.hstu_attention_packed(q, k, v, jnp.asarray(valid), rab, L,
                                         H, interpret=True, silu_qkv=True)

    jcore.packed = jcore.fused_silu = True
    mask = jnp.ones((1, L, L), bool)

    def jf(params, x):
        return (JH.hstu_block(params, x, mask, H, core=jcore)
                * jnp.asarray(cot)).sum()

    jp = jax.tree.map(jnp.asarray, p)
    want_out = JH.hstu_block(jp, jnp.asarray(x), mask, H, core=jcore)
    want_gp, want_gx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))

    def tcore(q, k, v, rab):
        return THA.hstu_attention_packed(q, k, v, torch.from_numpy(valid),
                                         rab, L, H, silu_qkv=True)

    tcore.fused_silu = True
    tp = {k: ({kk: torch.from_numpy(vv).requires_grad_(True)
               for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v).requires_grad_(True))
          for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TH.hstu_block(tp, xt, None, H, core=tcore)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx),
                               rtol=2e-4, atol=2e-5)
    flat = jax.tree_util.tree_flatten_with_path(want_gp)[0]
    for path, g in flat:
        keys = [k.key for k in path]
        t = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4,
                                   atol=2e-5, err_msg="/".join(keys))
