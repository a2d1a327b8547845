"""The port's RQ-VAE tokenizer and generative-retrieval head
(``models/rqvae.py``) and their trainers (``train/rqvae_trainer.py``)
against the JAX package's, on the CPU in f32: the same seeded numpy inputs
and the same JAX-initialised parameters (carried across by
``bridge.tree_from_jax``) through both. Forward values at rtol 1e-4 / atol
1e-5, gradients at 2e-4 / 2e-5, codes equal (each nearest-code margin above
1e-4, asserted), top-k ties by the lower index as ``jax.lax.top_k``; five
trainer steps replay the JAX trainers' own index draws."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tencent_recommendation_2025_tpu.config import RQVAEConfig
from tencent_recommendation_2025_tpu.models import rqvae as JR
from tencent_recommendation_2025_tpu.train import rqvae_trainer as JT
from tencent_recommendation_2025_tpu_torch.bridge import tree_from_jax
from tencent_recommendation_2025_tpu_torch.models import rqvae as TR
from tencent_recommendation_2025_tpu_torch.train import rqvae_trainer as TT

torch.set_num_threads(2)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
MARGIN = 1e-4

CFGS = {
    "small": RQVAEConfig(num_levels=2, codebook_size=16, code_dim=8,
                         enc_hidden=(32,), lr=3e-3),
    "three": RQVAEConfig(num_levels=3, codebook_size=32, code_dim=8,
                         enc_hidden=(48, 24)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """(path, array) of a nest of dicts and lists, torch or JAX leaves."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", a) for k in sorted(tree)
                for p, a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", a) for i, v in enumerate(tree)
                for p, a in _leaves(v)]
    a = tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return [("", a)]


def _assert_tree_close(got, want, **tol):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=p, **tol)


def _margins(residual, codebook):
    """Gap between the nearest and second-nearest code of each row, in
    f64."""
    r = np.asarray(residual, np.float64)
    c = np.asarray(codebook, np.float64)
    d = (c ** 2).sum(-1)[None] - 2.0 * r @ c.T
    d.sort(axis=1)
    return d[:, 1] - d[:, 0]


def _level_margins(params, z):
    """Each row's smallest nearest-code margin over the levels, along the
    quantizer's residuals."""
    cb = np.asarray(params["codebooks"], np.float64)
    res = np.asarray(z, np.float64)
    out = []
    for l in range(cb.shape[0]):
        out.append(_margins(res, cb[l]))
        d = (cb[l] ** 2).sum(-1)[None] - 2.0 * res @ cb[l].T
        res = res - cb[l][d.argmin(1)]
    return np.min(out, axis=0)


def _clear_rows(params, x, z):
    """The rows of ``x`` whose codes are clear of a near tie: every
    level's margin above MARGIN (the two packages' f32 products may round
    apart by far less)."""
    return x[_level_margins(params, z) > MARGIN]


def _rq(cfg, d_in, seed):
    """JAX-initialised RQ-VAE parameters: the JAX tree and the port's."""
    jp = JR.init_rqvae_params(jax.random.key(seed), cfg, d_in)
    return jp, tree_from_jax(_np(jp))


def _head(cfg, dq, seed, rng, jitter=0.3):
    """JAX-initialised decode head, perturbed so that its heads are
    non-trivial (as tests/test_rqvae_pipeline.py does)."""
    gp = JR.init_genret_params(jax.random.key(seed), cfg, dq)
    gp = jax.tree.map(lambda x: x + jitter * jnp.asarray(
        rng.standard_normal(x.shape), x.dtype), gp)
    return gp, tree_from_jax(_np(gp))


def test_tree_from_jax_keeps_lists():
    jp, tp = _rq(CFGS["three"], 12, 0)
    assert isinstance(tp["enc"], list) and len(tp["enc"]) == 3
    assert isinstance(tp["dec"], list) and len(tp["dec"]) == 3
    _assert_tree_close(tp, _np(jp), rtol=0, atol=0)


def test_nearest_code_matches_jax():
    rng = np.random.default_rng(0)
    res = rng.standard_normal((40, 8)).astype(np.float32)
    cb = rng.standard_normal((16, 8)).astype(np.float32)
    assert _margins(res, cb).min() > MARGIN
    want = np.asarray(JR.nearest_code(jnp.asarray(res), jnp.asarray(cb)))
    got = TR.nearest_code(torch.from_numpy(res), torch.from_numpy(cb))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_quantize_and_tokenize_match_jax(name):
    cfg = CFGS[name]
    d_in = 12
    jp, tp = _rq(cfg, d_in, 1)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((80, cfg.code_dim)).astype(np.float32) * 0.2
    z = _clear_rows(jp, z, z)
    assert len(z) >= 60 and _level_margins(jp, z).min() > MARGIN
    jzq, jc = JR.quantize(jp, jnp.asarray(z))
    tzq, tc = TR.quantize(tp, torch.from_numpy(z))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tzq.numpy(), np.asarray(jzq), **FWD)

    x = rng.standard_normal((70, d_in)).astype(np.float32)
    x = _clear_rows(jp, x, JR._mlp(jp["enc"], jnp.asarray(x)))
    assert len(x) >= 50
    assert _level_margins(jp, JR._mlp(jp["enc"], jnp.asarray(x))).min() \
        > MARGIN
    np.testing.assert_array_equal(
        TR.tokenize(tp, torch.from_numpy(x)).numpy(),
        np.asarray(JR.tokenize(jp, jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_rqvae_forward_losses_and_grads_match_jax(name):
    cfg = CFGS[name]
    d_in = 12
    jp, tp = _rq(cfg, d_in, 3)
    x = np.random.default_rng(4).standard_normal((48, d_in)).astype(
        np.float32)
    x = _clear_rows(jp, x, JR._mlp(jp["enc"], jnp.asarray(x)))[:32]
    assert len(x) == 32
    assert _level_margins(jp, JR._mlp(jp["enc"], jnp.asarray(x))).min() \
        > MARGIN

    def jloss(p):
        out = JR.rqvae_forward(p, jnp.asarray(x), cfg)
        return out[4]["loss"], out
    (_, (jrec, jz, jzq, jcodes, jl)), jg = jax.value_and_grad(
        jloss, has_aux=True)(jp)

    for layer in tp["enc"] + tp["dec"]:
        for t in layer.values():
            t.requires_grad_(True)
    trec, tz, tzq, tcodes, tl = TR.rqvae_forward(tp, torch.from_numpy(x),
                                                 cfg)
    tl["loss"].backward()
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    for k in ("loss", "recon", "commit"):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   err_msg=k, **FWD)
    for a, b in ((trec, jrec), (tz, jz), (tzq, jzq)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)
    for part in ("enc", "dec"):
        grads = [{k: t.grad for k, t in layer.items()} for layer in tp[part]]
        _assert_tree_close(grads, _np(jg[part]), **GRAD)
    # codebooks and EMA statistics take no gradient in either package
    np.testing.assert_array_equal(np.asarray(jg["codebooks"]), 0.0)
    assert not tp["codebooks"].requires_grad


def test_ema_codebook_update_matches_jax():
    cfg = CFGS["three"]
    jp, tp = _rq(cfg, 12, 5)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((64, cfg.code_dim)).astype(np.float32) * 0.2
    codes = rng.integers(0, cfg.codebook_size, (64, cfg.num_levels))
    want = JR.ema_codebook_update(jp, jnp.asarray(z), jnp.asarray(codes),
                                  cfg)
    got = TR.ema_codebook_update(tp, torch.from_numpy(z),
                                 torch.from_numpy(codes), cfg)
    for k in ("codebooks", "ema_counts", "ema_sums"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FWD)


def _genret_inputs(cfg, seed, B=6, dq=10):
    rng = np.random.default_rng(seed)
    jp, tp = _rq(cfg, 12, seed)
    jg, tg = _head(cfg, dq, seed + 1, rng)
    q = rng.standard_normal((B, dq)).astype(np.float32)
    return rng, jp, tp, jg, tg, q


@pytest.mark.parametrize("name", sorted(CFGS))
def test_genret_logits_loss_and_grads_match_jax(name):
    cfg = CFGS[name]
    rng, jp, tp, jg, tg, q = _genret_inputs(cfg, 7)
    codes = rng.integers(0, cfg.codebook_size, (q.shape[0], cfg.num_levels))
    jl = JR.genret_logits(jg, jp, jnp.asarray(q), jnp.asarray(codes), cfg)
    tl = TR.genret_logits(tg, tp, torch.from_numpy(q),
                          torch.from_numpy(codes), cfg)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
    jloss, jgrad = jax.value_and_grad(JR.genret_loss)(
        jg, jp, jnp.asarray(q), jnp.asarray(codes), cfg)
    for head in tg["heads"]:
        for t in head.values():
            t.requires_grad_(True)
    tloss = TR.genret_loss(tg, tp, torch.from_numpy(q),
                           torch.from_numpy(codes), cfg)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    _assert_tree_close([{k: t.grad for k, t in h.items()}
                        for h in tg["heads"]], _np(jgrad["heads"]), **GRAD)


@pytest.mark.parametrize("name,N,chunk_n", [("small", 50, 4096),
                                            ("small", 50, 16),
                                            ("three", 70, 32)])
def test_genret_scorers_match_jax(name, N, chunk_n):
    cfg = CFGS[name]
    rng, jp, tp, jg, tg, q = _genret_inputs(cfg, 8)
    item_codes = rng.integers(0, cfg.codebook_size, (N, cfg.num_levels))
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    jc, tc = jnp.asarray(item_codes), torch.from_numpy(item_codes)
    np.testing.assert_allclose(
        TR.genret_score_items(tg, tp, tq, tc, cfg).numpy(),
        np.asarray(JR.genret_score_items(jg, jp, jq, jc, cfg)), **FWD)
    want = np.asarray(JR.genret_score_items_exact(jg, jp, jq, jc, cfg,
                                                  chunk_n=chunk_n))
    got = TR.genret_score_items_exact(tg, tp, tq, tc, cfg, chunk_n=chunk_n)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("name,W", [("small", 4), ("three", 8),
                                    ("three", 64)])
def test_genret_beam_decode_matches_jax(name, W):
    cfg = CFGS[name]
    _, jp, tp, jg, tg, q = _genret_inputs(cfg, 9)
    jcodes, jscores = JR.genret_beam_decode(jg, jp, jnp.asarray(q), cfg,
                                            beam_width=W)
    tcodes, tscores = TR.genret_beam_decode(tg, tp, torch.from_numpy(q), cfg,
                                            beam_width=W)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               rtol=0, atol=1e-5)


def test_beam_retrieve_matches_jax():
    rng = np.random.default_rng(10)
    item_codes = rng.integers(0, 3, (40, 2))
    beams = rng.integers(0, 3, (5, 4, 2))
    scores = -np.sort(rng.random((5, 4)), axis=1)
    for k in (3, 10, 30):
        np.testing.assert_array_equal(
            TR.beam_retrieve(beams, scores, item_codes, k),
            JR.beam_retrieve(beams, scores, item_codes, k))


@pytest.mark.parametrize("shape,k", [((4, 50), 10), ((3, 2, 40), 7),
                                     ((2, 9), 9), ((5, 3000), 25)])
def test_top_k_breaks_ties_as_lax(shape, k):
    """Few distinct values: most of the top k are ties, which must come in
    index order as jax.lax.top_k gives them."""
    x = np.random.default_rng(11).integers(0, 4, shape).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = TR.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_shared_semantic_ids_rank_as_jax():
    """Items that share a semantic id score equal under the exact scorer;
    the top k of both packages then name the same items, in the same
    order, through the ties."""
    cfg = CFGS["small"]
    rng, jp, tp, jg, tg, q = _genret_inputs(cfg, 12)
    distinct = rng.integers(0, cfg.codebook_size, (6, cfg.num_levels))
    item_codes = distinct[rng.integers(0, 6, 80)]          # 80 items, 6 ids
    want = JR.genret_score_items_exact(jg, jp, jnp.asarray(q),
                                       jnp.asarray(item_codes), cfg)
    got = TR.genret_score_items_exact(tg, tp, torch.from_numpy(q),
                                      torch.from_numpy(item_codes), cfg)
    _, ji = jax.lax.top_k(want, 20)
    _, ti = TR.top_k(got, 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# trainers: five steps replaying the JAX trainers' index draws
# ---------------------------------------------------------------------------

def _clusters(seed, n_items=257, d=24):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)) * 3
    assign = rng.integers(0, 8, n_items)
    reprs = centers[assign] + 0.15 * rng.standard_normal((n_items, d))
    reprs[0] = 0
    return rng, assign, reprs.astype(np.float32)


def _draws(seed, steps, shape, lo, hi):
    """The JAX trainers' batch indices: one split of ``key(seed)`` per
    step."""
    key = jax.random.key(seed)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(
            jax.random.randint(k, shape, lo, hi)).astype(np.int64)))
    return out


STEPS = 5


def _jax_rqvae_losses(cfg, reprs, B, seed):
    """Per-step losses of the JAX trainer's step (train_rqvae's own body)
    on its draws."""
    params = JR.init_rqvae_params(jax.random.key(seed), cfg, reprs.shape[1])
    tx = optax.adam(cfg.lr)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, idx):
        x = jnp.take(jnp.asarray(reprs), idx, axis=0)

        def loss_fn(p):
            _, z, _, codes, losses = JR.rqvae_forward(p, x, cfg)
            return losses["loss"], (z, codes, losses)

        (_, (z, codes, losses)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt = tx.update(g, opt)
        params = optax.apply_updates(params, updates)
        return JR.ema_codebook_update(params, z, codes, cfg), opt, losses

    out = []
    for idx in _draws(seed + 1, STEPS, (B,), 1, reprs.shape[0]):
        params, opt, losses = step(params, opt, jnp.asarray(idx.numpy()))
        out.append({k: float(v) for k, v in losses.items()})
    return out


def test_rqvae_trainer_steps_match_jax():
    cfg, B, seed = CFGS["small"], 128, 0
    _, _, reprs = _clusters(0)
    want_losses = _jax_rqvae_losses(cfg, reprs, B, seed)
    want = JT.train_rqvae(reprs, cfg, num_steps=STEPS, batch_size=B,
                          seed=seed)
    _, params = _rq(cfg, reprs.shape[1], seed)
    step = TT.rqvae_step(params, torch.from_numpy(reprs), cfg)
    for i, idx in enumerate(_draws(seed + 1, STEPS, (B,), 1, len(reprs))):
        got = step(idx)
        for k in ("loss", "recon", "commit"):
            np.testing.assert_allclose(float(got[k]), want_losses[i][k],
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    _assert_tree_close(params, _np(want.params), rtol=0, atol=1e-4)
    for k, v in want.final_losses.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-4, err_msg=k)
    ids = TR.tokenize(params, torch.from_numpy(reprs)).numpy()
    ids[0] = 0
    np.testing.assert_array_equal(ids, want.semantic_ids)


def _jax_head_losses(rq, q, pos, cfg, B, seed):
    gp = JR.init_genret_params(jax.random.key(seed), cfg, q.shape[1])
    tx = optax.adam(1e-3)
    opt = tx.init(gp)
    codes_all = jnp.asarray(rq.semantic_ids, jnp.int32)

    @jax.jit
    def step(gp, opt, i):
        loss, g = jax.value_and_grad(lambda p: JR.genret_loss(
            p, rq.params, jnp.asarray(q)[i],
            codes_all[jnp.asarray(pos)[i]], cfg))(gp)
        updates, opt = tx.update(g, opt)
        return optax.apply_updates(gp, updates), opt, loss

    out = []
    for idx in _draws(seed + 2, STEPS, (B,), 0, len(q)):
        gp, opt, loss = step(gp, opt, jnp.asarray(idx.numpy()))
        out.append(float(loss))
    return out


def test_genret_head_trainer_steps_match_jax():
    cfg, B, seed = CFGS["small"], 256, 0
    rng, _, reprs = _clusters(1)
    rq = JT.train_rqvae(reprs, cfg, num_steps=50, batch_size=128)
    m = 300
    pos = rng.integers(1, len(reprs), m)
    q = (reprs[pos] + 0.1 * rng.standard_normal((m, reprs.shape[1]))
         ).astype(np.float32)
    want_losses = _jax_head_losses(rq, q, pos, cfg, B, seed)
    want = JT.train_genret_head(rq, q, pos, cfg, num_steps=STEPS,
                                batch_size=B, seed=seed)
    gp = tree_from_jax(_np(JR.init_genret_params(jax.random.key(seed), cfg,
                                                 q.shape[1])))
    step = TT.genret_step(gp, tree_from_jax(_np(rq.params)),
                          torch.from_numpy(q),
                          torch.from_numpy(rq.semantic_ids.astype(np.int64)),
                          torch.from_numpy(pos), cfg)
    for i, idx in enumerate(_draws(seed + 2, STEPS, (B,), 0, m)):
        np.testing.assert_allclose(float(step(idx)), want_losses[i],
                                   rtol=1e-4, err_msg=f"step {i}")
    _assert_tree_close(gp, _np(want["params"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(want_losses[-1], want["final_loss"],
                               rtol=1e-4)
