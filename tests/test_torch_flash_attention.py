"""The port's flash MHA (tencent_recommendation_2025_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernel run in
interpret mode on the CPU: the plain versions of the forward and backward
kernels (which a CPU tensor takes) through the port's autograd Function.
The CUDA kernels themselves are held to these plain versions on the card
(chip_smoke.py, tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.models.attention import \
    safe_masked_softmax as jsafe
from tencent_recommendation_2025_tpu.ops import flash_attention as JFA
from tencent_recommendation_2025_tpu_torch.ops import flash_attention as TFA
from tencent_recommendation_2025_tpu_torch.ops import hstu_attention as THA

torch.set_num_threads(2)

PAD = 37   # left padding of row 0: its first 37 queries see no valid key


def _inputs(B=3, L=256, D=64, seed=0):
    """q, k, v, dout [B, L, D] and the key-valid mask: row 0 left-padded,
    the last row fully padded."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, L, D)).astype(np.float32)
                   for _ in range(4))
    valid = np.ones((B, L), bool)
    valid[0, :PAD] = False
    valid[-1] = False
    return q, k, v, do, valid


def _jax(q, k, v, do, valid, H, dtype=jnp.float32):
    """The JAX kernel's output and its (dq, dk, dv) for the cotangent do."""
    args = [jnp.asarray(t, dtype) for t in (q, k, v)]

    def f(q, k, v):
        return JFA.flash_mha_packed(q, k, v, jnp.asarray(valid), H,
                                    interpret=True)

    out, vjp = jax.vjp(f, *args)
    return out, vjp(jnp.asarray(do, dtype))


def _port(q, k, v, do, valid, H, dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(t).to(dtype).requires_grad_(True)
                  for t in (q, k, v))
    out = TFA.flash_mha_packed(qt, kt, vt, torch.from_numpy(valid), H)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach(), (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("H", [1, 4])
def test_f32_forward_and_gradients_match_jax(H):
    """H=1 (hd=64, baseline_o1) and H=4 (hd=16, baseline) at L=256: forward
    at rtol 1e-4 / atol 1e-5, gradients at 2e-4 / 2e-5."""
    q, k, v, do, valid = _inputs(seed=H)
    ref, rgrads = _jax(q, k, v, do, valid, H)
    out, grads = _port(q, k, v, do, valid, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    # fully masked query rows and padded keys: exactly zero
    assert not out[-1].any() and not out[0, :PAD].any()
    for g in grads:
        assert not g[-1].any() and not g[0, :PAD].any()


def _cos(a, b):
    a, b = a.reshape(-1).astype(np.float64), b.reshape(-1).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("H", [1, 4])
def test_bf16_matches_jax_kernel(H):
    """In bf16 the port's plain version keeps the JAX kernel's rounding
    points (q scaled then rounded; p normalised then rounded), so the two
    differ by f32 summation order alone: max abs error <= 1/128 of max(1,
    max|ref|) (one bf16 step at that magnitude) and cosine >= 0.99999 for
    the output and each gradient."""
    q, k, v, do, valid = _inputs(seed=10 + H)
    ref, rgrads = _jax(q, k, v, do, valid, H, jnp.bfloat16)
    out, grads = _port(q, k, v, do, valid, H, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (ref, *rgrads)):
        g = got.float().numpy()
        w = np.asarray(want.astype(jnp.float32))
        assert np.abs(g - w).max() <= 1 / 128 * max(1.0, np.abs(w).max()), \
            name
        assert _cos(g, w) >= 0.99999, name


def test_packed_and_head_interfaces_agree():
    q, k, v, _, valid = _inputs(B=2, L=128, D=32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    packed = TFA.flash_mha_packed(*t, torch.from_numpy(valid), 2)

    def heads(a):
        return a.reshape(2, 128, 2, 16).transpose(1, 2)

    out = TFA.flash_mha(*(heads(a) for a in t), torch.from_numpy(valid))
    torch.testing.assert_close(out.transpose(1, 2).reshape(2, 128, 32),
                               packed)


def test_safe_masked_softmax_matches_jax():
    """Fully masked rows give 0 and finite gradients."""
    rng = np.random.default_rng(3)
    s = rng.standard_normal((2, 5, 7)).astype(np.float32)
    mask = rng.random((2, 5, 7)) > 0.4
    mask[1, 2] = False
    ref = jsafe(jnp.asarray(s), jnp.asarray(mask))
    st = torch.from_numpy(s).requires_grad_(True)
    got = TFA.safe_masked_softmax(st, torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-7)
    assert not got[1, 2].any()
    got.square().sum().backward()
    assert torch.isfinite(st.grad).all()


@pytest.mark.parametrize("D,H", [(32, 4), (128, 1)])
def test_head_dims_match_jax(D, H):
    """Head dims 8 (``baseline --hidden_units 32``) and 128
    (``baseline_o1 --hidden_units 128``), which the CUDA kernels take since
    their FMA and cut-tile paths: the plain version against the JAX kernel
    in f32."""
    q, k, v, do, valid = _inputs(D=D, seed=D)
    ref, rgrads = _jax(q, k, v, do, valid, H)
    out, grads = _port(q, k, v, do, valid, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_kernel_input_checks():
    """What the CUDA kernels do not take raises before a launch: D not a
    multiple of H, a head dim past 256 (NotImplementedError, ROADMAP Queue
    3), L not a multiple of 64, fp16, mismatched operands; a device without
    a kernel raises too. Every head dim up to 256 is taken."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    check = THA.check_attention_inputs
    check("k", 4, z(2, 256, 64), z(2, 256, 64))   # hd=16: taken
    check("k", 1, z(2, 256, 64, dtype=torch.bfloat16))
    for H, D in ((8, 64), (1, 128), (4, 72), (1, 256), (3, 24)):
        check("k", H, z(2, 256, D))                # hd 8, 128, 18, 256, 8
    with pytest.raises(ValueError, match="D % H"):
        check("k", 3, z(2, 256, 64))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        check("k", 1, z(2, 256, 264), max_head_dim=TFA.MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="L % 64"):
        check("k", 1, z(2, 96, 64))
    with pytest.raises(ValueError, match="bf16 or f32"):
        check("k", 1, z(2, 256, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="must match"):
        check("k", 1, z(2, 256, 64), z(2, 256, 64, dtype=torch.bfloat16))
    meta = torch.zeros((2, 256, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        TFA.flash_mha_fwd(meta, meta, meta, torch.ones(2, 256), 1)
    assert TFA.MAX_FLASH_L == JFA.MAX_FLASH_L


# ---------------------------------------------------------------------------
# the forward's row stats, which the backward kernels take
# ---------------------------------------------------------------------------

def _numpy_stats(q, k, valid, H, dtype):
    """Each query row's max over its visible scores (finfo(f32).min where
    none is visible) and sum of exp(score - max), in float64 from the same
    rounded operands: [2, B, H, L]."""
    B, L, D = q.shape
    hd = D // H
    qs = (torch.from_numpy(q).to(dtype).float() * hd ** -0.5).to(dtype)

    def heads(a):
        a = a.float().numpy().astype(np.float64)
        return a.reshape(B, L, H, hd).transpose(0, 2, 1, 3)

    s = heads(qs) @ heads(torch.from_numpy(k).to(dtype)).transpose(0, 1, 3, 2)
    mask = np.tril(np.ones((L, L), bool))[None, None] & valid[:, None, None, :]
    neg = np.finfo(np.float32).min
    m = np.where(mask, s, -np.inf).max(-1)
    m = np.where(np.isfinite(m), m, neg)
    z = np.where(mask, np.exp(np.minimum(s - m[..., None], 0.0)), 0.0).sum(-1)
    return np.stack([m, z])


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_stats_match_numpy(H, dtype):
    """``flash_mha_fwd(..., return_stats=True)`` on CPU tensors gives the
    rows' max and sum as numpy computes them from the same rounded q and k
    (rtol 1e-5: f32 against f64 sums), and on rows with no visible key (row
    0's left padding, the fully padded last row) exactly finfo(f32).min
    and 0."""
    q, k, v, _, valid = _inputs(seed=20 + H)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    out, stats = TFA.flash_mha_fwd(*t, torch.from_numpy(valid), H,
                                   return_stats=True)
    assert stats.shape == (2, 3, H, 256) and stats.dtype == torch.float32
    torch.testing.assert_close(
        out, TFA.flash_mha_fwd(*t, torch.from_numpy(valid), H), rtol=0,
        atol=0)
    want = _numpy_stats(q, k, valid, H, dtype)
    got = stats.double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    neg = torch.finfo(torch.float32).min
    for dead in (stats[:, 0, :, :PAD], stats[:, -1]):
        assert (dead[0] == neg).all() and (dead[1] == 0).all()
    assert (stats[1, 0, :, PAD:] >= 1).all()   # the max's own exp(0)


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_backward_with_stats_matches_jax(H, dtype):
    """``flash_mha_bwd_plain`` given the plain forward's stats against the
    JAX kernel's vjp (interpret mode), at this file's tolerances: f32 rtol
    2e-4 / atol 2e-5; bf16 max abs <= 1/128 of max(1, max|ref|) and cosine
    >= 0.99999."""
    q, k, v, do, valid = _inputs(seed=30 + H)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    _, rgrads = _jax(q, k, v, do, valid, H, jdt)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)]
    vt = torch.from_numpy(valid)
    _, stats = TFA.flash_mha_fwd_plain(*t[:3], vt, H, return_stats=True)
    grads = TFA.flash_mha_bwd_plain(*t, vt, H, stats)
    for name, got, want in zip(("dq", "dk", "dv"), grads, rgrads):
        g = got.float().numpy()
        w = np.asarray(want.astype(jnp.float32))
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        else:
            assert got.dtype == torch.bfloat16
            lim = 1 / 128 * max(1.0, np.abs(w).max())
            assert np.abs(g - w).max() <= lim, name
            assert _cos(g, w) >= 0.99999, name
        assert not got[-1].any() and not got[0, :PAD].any(), name


def test_flash_fn_passes_forward_stats_to_backward(monkeypatch):
    """``FlashMHAFn`` on CPU tensors hands the backward the very stats its
    forward made."""
    q, k, v, do, valid = _inputs(B=2, L=128, D=32)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    vt = torch.from_numpy(valid)
    seen = []
    real = TFA.flash_mha_bwd

    def spy(*args, **kw):
        seen.append(args[6] if len(args) > 6 else kw.get("stats"))
        return real(*args, **kw)

    monkeypatch.setattr(TFA, "flash_mha_bwd", spy)
    out = TFA.flash_mha_packed(*t, vt, 2)
    out.backward(torch.from_numpy(do))
    _, want = TFA.flash_mha_fwd(*(a.detach() for a in t), vt, 2,
                                return_stats=True)
    assert len(seen) == 1 and seen[0] is not None
    assert torch.equal(seen[0], want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "heads", "type"])
def test_backward_refuses_bad_stats(bad):
    """Stats of the wrong shape, dtype or head count, or not a tensor,
    raise ValueError before any launch."""
    q, k, v, do, valid = _inputs(B=2, L=128, D=32)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    vt = torch.from_numpy(valid)
    _, stats = TFA.flash_mha_fwd(*t[:3], vt, 2, return_stats=True)
    stats = {"shape": stats[:, :, :, :64], "dtype": stats.double(),
             "heads": stats.repeat(1, 1, 2, 1), "type": stats.tolist()}[bad]
    before = TFA.flash_mha_bwd.launches
    with pytest.raises(ValueError, match="stats"):
        TFA.flash_mha_bwd(*t, vt, 2, stats)
    assert TFA.flash_mha_bwd.launches == before
