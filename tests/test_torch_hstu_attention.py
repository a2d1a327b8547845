"""The port's standalone HSTU attention (tencent_recommendation_2025_tpu_torch/
ops/hstu_attention.py) against the JAX package's Pallas kernels run in
interpret mode on the CPU: the plain versions of the forward and backward
kernels (which a CPU tensor takes) through the port's autograd Function,
including the rel-pos gradient, which the JAX package folds back from its
bias-tile gradients with ``_bias_tiles_transpose``; whole-sequence and
chunked shapes (the ceilings cut to 128 in both packages), bucket limits,
head dims 8 to 128. The CUDA kernels are
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


#: (D, H) of each head width the card's wgmma kernels take in bf16: hd 8,
#: 16 (hstu_mini's 4 heads of 16), 32, 64 and 128
WGMMA_HEADS = [(32, 4), (64, 4), (64, 2), (64, 1), (128, 1)]


@pytest.mark.parametrize("D,H", WGMMA_HEADS)
def test_bf16_matches_jax_kernel(D, H):
    """In bf16 the port's plain version, which the card's kernels are held
    to, keeps the JAX kernel's rounding points (q scaled then rounded, a
    rounded after its 1/L and before a @ v, ds rounded before its
    products): max abs error <= 1/128 of max(1, max|ref|) (one bf16 step)
    and cosine >= 0.99999 for the output, dq, dk, dv and drab (an f32
    sum), at every head width of the wgmma route."""
    q, k, v, do, rab, valid = _inputs(D=D, H=H, seed=5 if D == 64 and H == 4
                                      else D + H)
    ref, rgrads = _jax(q, k, v, do, rab, valid, H, jnp.bfloat16)
    out, grads = _port(q, k, v, do, rab, valid, H, torch.bfloat16)
    for name, got, want in zip(("out", "dq", "dk", "dv", "drab"),
                               (out, *grads), (ref, *rgrads)):
        g = got.float().numpy().astype(np.float64).ravel()
        w = np.asarray(want.astype(jnp.float32)).astype(np.float64).ravel()
        assert np.abs(g - w).max() <= 1 / 128 * max(1.0, np.abs(w).max()), \
            name
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99999, \
            name


#: chunked shapes with both ceilings cut to 128: (L, H, D, buckets, the
#: bias-tile block the JAX package picks); from the third on at the 256
#: tile: 4 heads of 8, and 1794 buckets (the most that tile takes) at
#: L=2048, where distances past the last bucket clamp
CHUNKED = [(384, 1, 64, 300, 128), (384, 4, 64, 128, 128),
           (512, 1, 64, 300, 256), (512, 4, 64, 128, 256),
           (512, 4, 32, 128, 256), (2048, 1, 64, 1794, 256)]


def _cut_ceilings(monkeypatch):
    monkeypatch.setattr(JHA, "MAX_WHOLESEQ_L", 128)
    monkeypatch.setattr(THA, "MAX_WHOLESEQ_L", 128)


def test_chunked_shape_on_the_cpu_matches_jax_chunked_kernels(monkeypatch):
    """Past ``_use_long`` the JAX package takes its chunked kernels; on the
    CPU the port's plain version computes the same function (both ceilings
    cut to 128 so that L=384 is chunked)."""
    _cut_ceilings(monkeypatch)
    assert JHA._use_long(384, 32) and THA._use_long(384, 32)
    q, k, v, do, rab, valid = _inputs(B=2, L=384, buckets=300, seed=9)
    ref, rgrads = _jax(q, k, v, do, rab, valid, 2)
    out, grads = _port(q, k, v, do, rab, valid, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("L,H,D,buckets,blk", CHUNKED)
def test_chunked_shapes_match_jax_chunked_kernels(monkeypatch, L, H, D,
                                                  buckets, blk):
    """Past ``_use_long`` the JAX package takes its chunked kernels
    (``_fwd_kernel_chunk``, ``_dq_kernel_chunk``, ``_dkdv_kernel_chunk``,
    at a 128 or a 256 tile); the port's plain version, which the chunked
    wrappers take on the CPU, computes the same function in f32: forward at
    rtol 1e-4 / atol 1e-5, gradients at 2e-4 / 2e-5."""
    _cut_ceilings(monkeypatch)
    assert JHA._use_long(L, D) and THA._use_long(L, D)
    assert THA._tile_blk(L, H, buckets, D) == \
        JHA._tile_blk(L, H, buckets, D) == blk
    q, k, v, do, rab, valid = _inputs(B=2, L=L, D=D, H=H, buckets=buckets,
                                      seed=L + H)
    ref, rgrads = _jax(q, k, v, do, rab, valid, H)
    out, grads = _port(q, k, v, do, rab, valid, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def _bf16_close(got, want, names):
    """One bf16 step of max(1, max|ref|) and cosine >= 0.99999 for each
    output (the two differ by f32 summation order alone)."""
    for name, g, w in zip(names, got, want):
        g = g.float().numpy().astype(np.float64).ravel()
        w = np.asarray(w.astype(jnp.float32)).astype(np.float64).ravel()
        assert np.abs(g - w).max() <= 1 / 128 * max(1.0, np.abs(w).max()), \
            name
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99999, \
            name


@pytest.mark.parametrize("L,H,D,buckets,blk", CHUNKED[2:])
def test_chunked_bf16_matches_jax_chunked_kernel(monkeypatch, L, H, D,
                                                 buckets, blk):
    """bf16 at the 256 tile: the plain version keeps the JAX chunked
    kernels' rounding points (f32 accumulator across key tiles, output
    rounded once), 1794 buckets included."""
    _cut_ceilings(monkeypatch)
    assert THA._tile_blk(L, H, buckets, D) == \
        JHA._tile_blk(L, H, buckets, D) == blk
    q, k, v, do, rab, valid = _inputs(B=2, L=L, D=D, H=H, buckets=buckets,
                                      seed=7 + H)
    ref, rgrads = _jax(q, k, v, do, rab, valid, H, jnp.bfloat16)
    out, grads = _port(q, k, v, do, rab, valid, H, torch.bfloat16)
    _bf16_close((out, *grads), (ref, *rgrads),
                ("out", "dq", "dk", "dv", "drab"))


def test_bucket_limit_follows_the_tile(monkeypatch):
    """1000 buckets take 5 of the 8 bias-tile slots at a 256 tile and 9 at
    a 128 tile: the JAX package runs them on its chunked route (L=512, H=1)
    and raises its ValueError on the whole-sequence one (L=256) and where
    the chunked tile is 128 (L=384); the port runs and raises exactly
    there, with the same message."""
    _cut_ceilings(monkeypatch)
    q, k, v, do, rab, valid = _inputs(B=2, L=512, D=64, H=1, buckets=1000,
                                      seed=21)
    ref, rgrads = _jax(q, k, v, do, rab, valid, 1)
    out, grads = _port(q, k, v, do, rab, valid, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    for L in (256, 384):
        monkeypatch.setattr(JHA, "MAX_WHOLESEQ_L", 128 if L == 384 else 1024)
        monkeypatch.setattr(THA, "MAX_WHOLESEQ_L", 128 if L == 384 else 1024)
        q, k, v, do, rab, valid = _inputs(B=1, L=L, D=64, H=1, buckets=1000)
        with pytest.raises(ValueError) as theirs:
            _jax(q, k, v, do, rab, valid, 1)
        with pytest.raises(ValueError) as mine:
            _port(q, k, v, do, rab, valid, 1)
        assert str(mine.value) == str(theirs.value)
        assert "at most 8" in str(mine.value)


@pytest.mark.parametrize("D,H", [(32, 4), (128, 1)])
def test_head_dims_match_jax(D, H):
    """Head dims 8 and 128, which the CUDA kernels take since their FMA and
    cut-tile paths: the plain version against the JAX kernel in f32."""
    q, k, v, do, rab, valid = _inputs(B=2, D=D, H=H, seed=D)
    ref, rgrads = _jax(q, k, v, do, rab, valid, H)
    out, grads = _port(q, k, v, do, rab, valid, H)
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
    """The chunked dispatch is the JAX package's; hstu_mini takes the core
    route on the card at every long L (the chunked kernels); every head
    width is taken by the HSTU kernels' input check (hd 512 and 1024 as
    hd 256), while a bad shape still raises before any launch."""
    for L in (256, 512, 1024, 2048, 4096):
        for D in (16, 64, 128, 256, 512):
            assert THA._use_long(L, D) == JHA._use_long(L, D), (L, D)
    mini = PRESETS["hstu_mini"]().model
    for L in (1024, 2048, 4096, 16384):
        assert TENC.block_route(mini, L, "cuda") == "core"
    assert TENC.block_route(mini, 2048, "cpu") == "dense"
    wide = torch.zeros((1, 256, 512))
    THA.check_attention_inputs("k", 1, wide)          # hd 512: taken
    THA.check_attention_inputs("k", 2, wide)          # hd 256: taken
    THA.check_attention_inputs("k", 1, torch.zeros((1, 256, 1024)))
    with pytest.raises(ValueError, match="L % 64"):
        THA.check_attention_inputs("k", 1, torch.zeros((1, 96, 512)))


#: heads past 256 (hd 320 and 512), whole-sequence (L * D <= 1024 * 64)
#: and chunked in both packages: (L, D, H)
WIDE_HEADS = [(128, 320, 1), (128, 512, 1), (256, 640, 2), (256, 512, 1)]


@pytest.mark.parametrize("L,D,H", WIDE_HEADS)
def test_wide_heads_match_jax(L, D, H):
    """A head wider than 256 takes the port's plain versions, which equal
    the JAX kernels (interpret mode) at the f32 tolerances: forward rtol
    1e-4 / atol 1e-5, dq, dk, dv and drab 2e-4 / 2e-5, on the JAX
    package's whole-sequence or chunked route as its dispatch picks."""
    assert JHA._use_long(L, D) == THA._use_long(L, D) == (L == 256)
    q, k, v, do, rab, valid = _inputs(B=2, L=L, D=D, H=H, seed=D + L)
    q, k, v, do = (t * 0.5 for t in (q, k, v, do))
    ref, rgrads = _jax(q, k, v, do, rab, valid, H)
    out, grads = _port(q, k, v, do, rab, valid, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    for name, g, r in zip(("dq", "dk", "dv", "drab"), grads, rgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


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
