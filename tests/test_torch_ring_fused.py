"""The port's sequence-parallel path (ops/fused_block's ring units,
parallel/ring_fused.py, parallel/ring_attention.py, the encoder's ring
routes, compute_loss on a mesh) against the JAX package's ring-fused path
on its 8-fake-device CPU mesh, in interpret mode, in f32.

As tests/test_ring_fused.py does, the JAX gate is forced (it wants a TPU)
and the JAX attention tile shrinks to 128 (``FB_ATTN_BLK``), so each shard
holds more than one tile; the port's gate is forced the same way (it wants
the card), so its ring units run their plain versions, the arithmetic the
CUDA kernels are held to on the card (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``). Inputs come from numpy with a seed,
parameters through ``bridge.params_from_jax``. Tolerances: forward f32 rtol
1e-4 / atol 1e-5, gradients 2e-4 / 2e-5 for the units; the JAX ring test's
own for the encoder and the loss (2e-5 / 2e-6 out, 2e-3 / 2e-5 gradients)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import MeshConfig as JMesh
from tencent_recommendation_2025_tpu.config import ModelConfig as JConfig
from tencent_recommendation_2025_tpu.models import encoder as JENC
from tencent_recommendation_2025_tpu.ops import fused_block as JFB
from tencent_recommendation_2025_tpu.parallel import ring_attention as JRA
from tencent_recommendation_2025_tpu.parallel.mesh import build_mesh
from tencent_recommendation_2025_tpu_torch.bridge import _flatten, \
    params_from_jax
from tencent_recommendation_2025_tpu_torch.config import MeshConfig, \
    ModelConfig
from tencent_recommendation_2025_tpu_torch.models import encoder as TENC
from tencent_recommendation_2025_tpu_torch.ops import fused_block as TFB
from tencent_recommendation_2025_tpu_torch.parallel import \
    ring_attention as TRA
from tencent_recommendation_2025_tpu_torch.parallel.mesh import local_mesh

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
B, D, LC = 2, 32, 256


@pytest.fixture
def forced(monkeypatch):
    """Both packages' ring gates forced past their device test; the JAX
    attention tile at 128."""
    jreal, treal = JFB.ring_fused_supported, TFB.ring_fused_supported
    monkeypatch.setattr(JFB, "ring_fused_supported",
                        lambda cfg, L, S, b: jreal(cfg, L, S, "tpu"))
    monkeypatch.setattr(TFB, "ring_fused_supported",
                        lambda cfg, L, S, b: treal(cfg, L, S, "cuda"))
    monkeypatch.setattr(JFB, "FB_ATTN_BLK", 128)


def _np(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _t(a):
    """[B, D, L] JAX array -> [B, L, D] numpy."""
    return np.swapaxes(np.asarray(a), 1, 2)


def _tj(a):
    """[B, L, D] numpy -> [B, D, L] JAX array."""
    return jnp.asarray(np.swapaxes(a, 1, 2))


def _valid(L, pad=37):
    """[B, L] validity: row 0 left-padded."""
    v = np.ones((B, L), np.int32)
    v[0, :pad] = 0
    return v


def _block(H, seed=0):
    """A JAX block's params with every leaf off its init, and the port's
    copy (leaves that take gradients)."""
    cfg = JConfig(hidden_units=D, num_heads=H, block_type="hstu",
                  ffn_type="swiglu", dtype="float32", dropout_rate=0.0,
                  reference_init=False)
    rng = np.random.default_rng(seed)
    jbp = JENC.init_block_params(jax.random.key(seed), cfg)
    jbp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jbp)

    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        return t.requires_grad_(True)

    return jbp, req(params_from_jax(jax.tree.map(np.asarray, jbp)))


@pytest.mark.parametrize("off", [0, LC, -LC, 2 * LC])
@pytest.mark.parametrize("H", [1, 2])
def test_pair_attention_matches_jax(forced, H, off):
    """Row 10 forward, rows 11-12 backward (dq, drab; dk, dv)."""
    rng = np.random.default_rng(1000 + 10 * H + off)
    q, k, v = (_np(rng, (B, LC, D), 0.5) for _ in range(3))
    rab = _np(rng, (H, 128), 0.1)
    valid = _valid(LC)
    dav = _np(rng, (B, LC, D))

    def f(qt, kt, vt, r):
        return JFB.ring_pair_attn(qt, kt, vt, jnp.asarray(valid)[:, :, None],
                                  r, off, H, True)

    jout, vjp = jax.vjp(f, _tj(q), _tj(k), _tj(v), jnp.asarray(rab))
    jdq, jdk, jdv, jdrab = vjp(_tj(dav))

    tq, tk, tv, trab = (torch.from_numpy(a).requires_grad_(True)
                        for a in (q, k, v, rab))
    out = TFB.RingPairAttnFn.apply(tq, tk, tv, trab,
                                   torch.from_numpy(valid), off, H)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), _t(jout), **FWD)
    (out * torch.from_numpy(dav)).sum().backward()
    if off + LC <= 0:      # every pair in the future: no gradient at all
        assert tq.grad is None and trab.grad is None
        assert not np.asarray(jdq).any() and not np.asarray(jdrab).any()
        return
    for got, want in ((tq.grad, _t(jdq)), (tk.grad, _t(jdk)),
                      (tv.grad, _t(jdv)), (trab.grad, np.asarray(jdrab))):
        np.testing.assert_allclose(got.numpy(), want, **GRAD)


@pytest.mark.parametrize("off", [0, LC])
@pytest.mark.parametrize("H", [1, 4])
def test_pair_attention_bf16_matches_jax(forced, H, off):
    """Row 10 forward in bf16 (the card's instance, pair_fwd_wgmma_kernel,
    is held to this plain version in bf16): q, k, v rounded to bf16 once
    and given to both; the partial is f32 in both. The rounding points are
    the same (a rounded to bf16 as the product's operand, f32 sums), so the
    two differ only where a score summed in another order rounds a to the
    neighbouring bf16 value (2^-8 relative) on a few of a row's LC pairs:
    held to atol 2e-3, rtol 2e-3 (|partial| up to about 35 here, v not
    scaled by 1/L; the largest difference seen is 1.2e-3, and an offset
    off by 16 tokens is 1.5-9.5 away)."""
    rng = np.random.default_rng(2000 + 10 * H + off)
    q, k, v = (_np(rng, (B, LC, D), 0.5) for _ in range(3))
    rab = _np(rng, (H, 128), 0.1)
    valid = _valid(LC)
    jq, jk, jv = (_tj(a).astype(jnp.bfloat16) for a in (q, k, v))
    jout = JFB.ring_pair_attn(jq, jk, jv, jnp.asarray(valid)[:, :, None],
                              jnp.asarray(rab), off, H, True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = TFB.ring_pair_fwd(tq, tk, tv, torch.from_numpy(valid),
                            torch.from_numpy(rab), off, H)
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), _t(jout), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("H", [1, 2])
def test_pre_stage_matches_jax(H):
    """ring_pre_proj: q, k, v, u on a shard (1/L of the whole sequence) and
    its VJP, through RingPreProjFn."""
    jbp, bp = _block(H, seed=H)
    rng = np.random.default_rng(7)
    x = _np(rng, (B, LC, D), 0.5)
    cots = [_np(rng, (B, LC, D)) for _ in range(4)]
    L = 2 * LC
    _, lnt, wuvqk, buvqkt, *_ = JFB._block_operands(jbp, jnp.float32)

    def f(xt, lnt, w, b):
        return JFB.ring_pre_proj(xt, lnt, w, b, L, H, True)

    jouts, vjp = jax.vjp(f, _tj(x), lnt, wuvqk, buvqkt)
    jdx, jdln, jdw, jdb = vjp(tuple(_tj(c) for c in cots))

    ops = TFB.block_operands(bp, torch.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = TFB.leaves_of(bp, TFB.PRE_LEAVES)
    outs = TFB.RingPreProjFn.apply(tx, ops, L, H, *leaves)
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got.detach().numpy(), _t(want), **FWD)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)) \
        .backward()
    np.testing.assert_allclose(tx.grad.numpy(), _t(jdx), **GRAD)
    jdln = np.asarray(jdln)
    for got, want in zip(leaves, (jdln[:, 0], jdln[:, 1], np.asarray(jdw),
                                  np.asarray(jdb)[:, 0])):
        np.testing.assert_allclose(got.grad.numpy(), want, **GRAD)


@pytest.mark.parametrize("H", [1, 2])
def test_post_stage_matches_jax(H):
    """ring_post_gate on a shard and its VJP (x, av, u and the weights),
    through RingPostGateFn."""
    jbp, bp = _block(H, seed=10 + H)
    rng = np.random.default_rng(8)
    x = _np(rng, (B, LC, D), 0.5)
    av = _np(rng, (B, LC, D), 0.05)
    cot = _np(rng, (B, LC, D))
    L = 2 * LC
    ops = TFB.block_operands(bp, torch.float32)
    with torch.no_grad():
        u = TFB.ring_pre_fwd_plain(torch.from_numpy(x), ops, L, H)[3]
    _, lnt, wuvqk, buvqkt, wo, bot, w13, w2 = JFB._block_operands(
        jbp, jnp.float32)

    def f(xt, avt, ut, lnt, wo, bot, w13, w2):
        return JFB.ring_post_gate(xt, avt, ut, lnt, wuvqk, buvqkt, wo, bot,
                                  w13, w2, jnp.int32(0), L, H, 0.0, False,
                                  True)

    jout, vjp = jax.vjp(f, _tj(x), _tj(av), _tj(u.numpy()), lnt, wo, bot,
                        w13, w2)
    jdx, jdav, jdu, jdln, jdwo, jdbo, jdw13, jdw2 = vjp(_tj(cot))

    tx, tav, tu = (torch.from_numpy(a).requires_grad_(True)
                   for a in (x, av, u.numpy()))
    leaves = TFB.leaves_of(bp, TFB.POST_LEAVES)
    out = TFB.RingPostGateFn.apply(tx, tav, tu, ops, 0, 0.0, L, H, *leaves)
    np.testing.assert_allclose(out.detach().numpy(), _t(jout), **FWD)
    (out * torch.from_numpy(cot)).sum().backward()
    jdln = np.asarray(jdln)
    for got, want in ((tx.grad, _t(jdx)), (tav.grad, _t(jdav)),
                      (tu.grad, _t(jdu))) + tuple(zip(
                          [lf.grad for lf in leaves],
                          (jdln[:, 2], jdln[:, 3], jdln[:, 4], jdln[:, 5],
                           np.asarray(jdwo), np.asarray(jdbo)[:, 0],
                           np.asarray(jdw13), np.asarray(jdw2)))):
        np.testing.assert_allclose(got.numpy(), want, **GRAD)


def test_post_stage_dropout_masks():
    """The post stage's dropout: the same seed reproduces its masks, the
    seed of another shard (folded as ring_fused folds it) draws others, and
    evaluation ignores dropout."""
    _, bp = _block(1, seed=3)
    rng = np.random.default_rng(9)
    x, av = (torch.from_numpy(_np(rng, (B, LC, D), s)) for s in (0.5, 0.05))
    ops = TFB.block_operands(bp, torch.float32)
    u = TFB.ring_pre_fwd_plain(x, ops, 2 * LC, 1)[3]
    with torch.no_grad():
        def post(seed, rate):
            return TFB.ring_post_fwd(x, av, u, ops, seed, rate)

        a, b = post(5, 0.5), post(5, 0.5)
        other_shard = post(5 + 1 * 1000003, 0.5)
        other_data = post(5 + 1 * 10007, 0.5)
        evaluation = post(5, 0.0)
    assert torch.equal(a, b)
    for o in (other_shard, other_data, evaluation):
        assert not torch.allclose(a, o)


def _enc_setup(L, H, nb=2, seed=0):
    """tests/test_ring_fused.py's setup (B=4, D=32, left padding of a
    different width per row), for both packages."""
    jcfg = JConfig(hidden_units=D, num_blocks=nb, num_heads=H, maxlen=L - 1,
                   block_type="hstu", ffn_type="swiglu", dtype="float32",
                   reference_init=False, dropout_rate=0.0)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    rng = np.random.default_rng(seed)
    params = JENC.init_encoder_params(jax.random.key(seed), jcfg)
    pos = _np(rng, (2 * L + 1, D), 0.02)
    emb = _np(rng, (4, L, D), 0.1)
    seq_ids = rng.integers(1, 50, (4, L)).astype(np.int32)
    tt = np.ones((4, L), np.int32)
    for i in range(4):
        tt[i, : (i * 7) % (L // 2)] = 0
    return jcfg, cfg, params, emb, seq_ids * (tt != 0), tt, pos


def _port_encode(cfg, params, emb, seq_ids, tt, pos, mesh, route=None):
    """(output, {leaf path: gradient}) of the weighted sum the JAX ring
    test differentiates."""
    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        return t.requires_grad_(True)

    p = req(params_from_jax(jax.tree.map(np.asarray, params)))
    e = torch.from_numpy(emb).requires_grad_(True)
    out = TENC.encode(p, e, torch.from_numpy(seq_ids), torch.from_numpy(tt),
                      torch.from_numpy(pos), cfg, mesh=mesh, route=route)
    w = torch.arange(out.numel(), dtype=out.dtype).reshape(out.shape)
    ((out * w).sum() * 1e-6).backward()
    grads = {k: t.grad for k, t in _flatten(p).items()}
    grads["emb"] = e.grad
    return out.detach().numpy(), grads


@requires_8
def test_encode_on_seq_mesh_matches_jax(forced):
    """The slice's encoder: port on a local seq=2 mesh against JAX's
    ring-fused encode on a data=2 x seq=2 fake mesh, L=512, H=2."""
    L, H = 512, 2
    jcfg, cfg, params, emb, seq_ids, tt, pos = _enc_setup(L, H)
    mesh = build_mesh(JMesh(data=2, seq=2), devices=jax.devices()[:4])

    def f(p, e):
        out = JENC.encode(p, e, jnp.asarray(seq_ids), jnp.asarray(tt),
                          jnp.asarray(pos), jcfg, train=False, mesh=mesh)
        w = jnp.arange(out.size, dtype=out.dtype).reshape(out.shape)
        return jnp.sum(out * w) * 1e-6, out

    (_, jout), (jg, jge) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        params, jnp.asarray(emb))
    tmesh = local_mesh(MeshConfig(seq=2))
    assert TENC.block_route(cfg, L, "cpu", tmesh) == "ring_fused"
    out, grads = _port_encode(cfg, params, emb, seq_ids, tt, pos, tmesh)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=2e-5, atol=2e-6)
    want = _flatten(params_from_jax(jax.tree.map(np.asarray, jg)))
    want["emb"] = np.asarray(jge)
    assert set(want) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=2e-3, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("S", [2, 4])
def test_local_mesh_matches_single_device(forced, S):
    """The ring on 2 and 4 shards (L=1024, H=1) against the port's
    single-device fused route, both through the plain versions."""
    L = 1024
    _, cfg, params, emb, seq_ids, tt, pos = _enc_setup(L, 1, seed=S)
    emb, seq_ids, tt = emb[:2], seq_ids[:2], tt[:2]
    mesh = local_mesh(MeshConfig(seq=S))
    out, grads = _port_encode(cfg, params, emb, seq_ids, tt, pos, mesh)
    ref, ref_grads = _port_encode(cfg, params, emb, seq_ids, tt, pos, None,
                                  route="fused")
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[k].numpy(),
                                   rtol=2e-3, atol=2e-5, err_msg=k)


@requires_8
@pytest.mark.parametrize("kind", ["mha", "hstu"])
def test_unfused_ring_matches_jax(kind):
    """The unfused ring cores (softmax MHA, HSTU) against JAX
    ring_attention / ring_hstu_attention on a seq=2 fake mesh, output and
    the q, k, v gradients."""
    L, H, hd = 256, 2, 16
    rng = np.random.default_rng(31)
    q, k, v, cot = (_np(rng, (B, L, H * hd), 0.5) for _ in range(4))
    rab = _np(rng, (H, 128), 0.1)
    valid = _valid(L, pad=53)
    mesh = build_mesh(JMesh(seq=2), devices=jax.devices()[:2])

    def heads(a):
        return jnp.asarray(a.reshape(B, L, H, hd).transpose(0, 2, 1, 3))

    def rows(a):
        return np.asarray(a).transpose(0, 2, 1, 3).reshape(B, L, H * hd)

    jvalid = jnp.asarray(valid != 0)
    if kind == "mha":
        def f(q, k, v):
            return JRA.ring_attention(mesh, q, k, v, jvalid)
    else:
        def f(q, k, v):
            return JRA.ring_hstu_attention(mesh, q, k, v, jvalid,
                                           jnp.asarray(rab), hd ** -0.5, L)
    jout, vjp = jax.vjp(f, heads(q), heads(k), heads(v))
    jgrads = vjp(heads(cot))

    tmesh = local_mesh(MeshConfig(seq=2))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    if kind == "mha":
        out = TRA.ring_attention(tmesh, tq, tk, tv, tvalid, H)
    else:
        out = TRA.ring_hstu_attention(tmesh, tq, tk, tv, tvalid,
                                      torch.from_numpy(rab), H, hd ** -0.5,
                                      L)
    np.testing.assert_allclose(out.detach().numpy(), rows(jout), **FWD)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), rows(want), **GRAD)


def test_ring_fused_supported_gate():
    cfg = ModelConfig(hidden_units=64, num_heads=1, block_type="hstu",
                      ffn_type="swiglu")
    assert TFB.ring_fused_supported(cfg, 1024, 2, "cuda")
    assert TFB.ring_fused_supported(cfg, 4096, 4, "cuda")
    assert not TFB.ring_fused_supported(cfg, 1024, 2, "cpu")
    assert not TFB.ring_fused_supported(cfg, 1024, 8, "cuda")  # Lc 128
    assert not TFB.ring_fused_supported(cfg, 1000, 2, "cuda")
    assert not TFB.ring_fused_supported(
        dataclasses.replace(cfg, block_type="mha"), 1024, 2, "cuda")
    assert not TFB.ring_fused_supported(
        dataclasses.replace(cfg, ffn_type="relu"), 1024, 2, "cuda")
    # the ring routes of the encoder follow the gate
    mesh = local_mesh(MeshConfig(seq=2))
    assert TENC.block_route(cfg, 1024, "cuda", mesh) == "ring_fused"
    assert TENC.block_route(cfg, 1024, "cpu", mesh) == "ring"
    assert TENC.block_route(cfg, 1024, "cuda") == "fused"


@requires_8
def test_compute_loss_on_seq_mesh_matches_jax(forced, synth_dir):
    """The slice's loss: the port's compute_loss on a local seq=2 mesh
    against JAX compute_loss on a data=2 x seq=2 fake mesh under
    value_and_grad: hstu_flagship cut to D=32, 2 blocks of 2 heads,
    --maxlen 511 (L=512), batch 4, BCE, dropout off, on the synthetic
    fixture."""
    from tencent_recommendation_2025_tpu.config import PRESETS as JPRESETS
    from tencent_recommendation_2025_tpu.data.dataset import \
        TrainSampler as JSampler
    from tencent_recommendation_2025_tpu.data.featurizer import \
        FusedVocab as JFused, build_item_tables as jbuild
    from tencent_recommendation_2025_tpu.data.pipeline import \
        TrainLoader as JLoader
    from tencent_recommendation_2025_tpu.data.readers import \
        TencentGRData as JData
    from tencent_recommendation_2025_tpu.data.schema import \
        FeatureSchema as JSch
    from tencent_recommendation_2025_tpu.models.baseline import \
        SeqRecModel as JModel
    from tencent_recommendation_2025_tpu.train import trainer as JTR
    from tencent_recommendation_2025_tpu_torch.config import PRESETS
    from tencent_recommendation_2025_tpu_torch.data.featurizer import (
        FusedVocab, build_item_tables)
    from tencent_recommendation_2025_tpu_torch.data.readers import \
        TencentGRData
    from tencent_recommendation_2025_tpu_torch.data.schema import \
        FeatureSchema
    from tencent_recommendation_2025_tpu_torch.models.baseline import \
        SeqRecModel
    from tencent_recommendation_2025_tpu_torch.train import trainer as TTR

    def cfg_of(presets):
        c = presets["hstu_flagship"]()
        return c.replace(
            model=dataclasses.replace(c.model, hidden_units=D, num_blocks=2,
                                      num_heads=2, maxlen=511,
                                      dropout_rate=0.0, dtype="float32"),
            train=dataclasses.replace(c.train, batch_size=4,
                                      tower_dedup=False))

    jcfg, cfg = cfg_of(JPRESETS), cfg_of(PRESETS)
    jdata = JData(synth_dir, mm_emb_ids=("81",))
    jschema = JSch.from_indexer(jdata.indexer, ("81",), 8)
    jtab = jbuild(jdata.item_feat_dict, jdata.itemnum, jschema,
                  jdata.mm_emb_dict, jdata.indexer_i_rev)
    jmodel = JModel(cfg=jcfg.model, schema=jschema,
                    fused=JFused.build(jschema), usernum=jdata.usernum,
                    itemnum=jdata.itemnum)
    rng = np.random.default_rng(12)
    jparams = jmodel.init(jax.random.key(3))
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.05,
                                        a.dtype)
        if str(path[-1].key) in ("b", "bias", "scale", "rab") else a,
        jparams)
    loader = JLoader(JSampler(jdata, jschema, 511), np.arange(32), 4, seed=1,
                     num_workers=1)
    batch = next(iter(loader.epoch(1)))
    dtab = JTR.device_tables(jtab)
    mesh = build_mesh(JMesh(data=2, seq=2), devices=jax.devices()[:4])

    def loss_fn(p):
        return JTR.compute_loss(jmodel, p, jax.device_put(batch), dtab["mm"],
                                dtab, jcfg, train=True,
                                rng=jax.random.key(0), mesh=mesh)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)

    data = TencentGRData(synth_dir, mm_emb_ids=("81",))
    schema = FeatureSchema.from_indexer(data.indexer, ("81",), 8)
    tab = build_item_tables(data.item_feat_dict, data.itemnum, schema,
                            data.mm_emb_dict, data.indexer_i_rev)
    model = SeqRecModel(cfg=cfg.model, schema=schema,
                        fused=FusedVocab.build(schema), usernum=data.usernum,
                        itemnum=data.itemnum)
    state = TTR.init_state(model, cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    tabs = TTR.device_tables(tab, "cpu")
    tmesh = local_mesh(MeshConfig(seq=2))
    assert TENC.block_route(cfg.model, 512, "cpu", tmesh) == "ring_fused"
    loss, _ = TTR.compute_loss(model, state.params,
                               TTR.put_batch(batch, "cpu"), tabs["mm"], tabs,
                               cfg, train=True, mesh=tmesh)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-5,
                               atol=2e-6)
    want = _flatten(params_from_jax(jax.tree.map(np.asarray, jgrads)))
    got = {p: t.grad for p, t in TTR.param_leaves(state.params)}
    assert set(got) == set(want)
    for k, g in got.items():
        g = np.zeros(tuple(want[k].shape), np.float32) if g is None \
            else g.numpy()
        np.testing.assert_allclose(g, np.asarray(want[k], np.float32),
                                   rtol=2e-3, atol=2e-5, err_msg=k)
