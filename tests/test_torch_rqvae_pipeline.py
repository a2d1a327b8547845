"""The semantic-ID pipeline through the port on the CPU: its versions of
tests/test_rqvae_pipeline.py's three tests at the JAX package's
thresholds, the serving artifacts across the two packages in both
directions (bitwise), and the two packages' ``run_semantic_ann`` on the
same JAX-trained artifacts writing the same ``id100.u64bin``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.config import RQVAEConfig
from tencent_recommendation_2025_tpu.models import rqvae as JR
from tencent_recommendation_2025_tpu.retrieval import semantic_serve as JSS
from tencent_recommendation_2025_tpu.train import rqvae_trainer as JT
from tencent_recommendation_2025_tpu_torch.bridge import tree_from_jax
from tencent_recommendation_2025_tpu_torch.config import RetrievalConfig
from tencent_recommendation_2025_tpu_torch.data import formats
from tencent_recommendation_2025_tpu_torch.models import rqvae as TR
from tencent_recommendation_2025_tpu_torch.retrieval import \
    semantic_serve as TSS
from tencent_recommendation_2025_tpu_torch.train import rqvae_trainer as TT

torch.set_num_threads(2)

CFG = RQVAEConfig(num_levels=2, codebook_size=16, code_dim=8,
                  enc_hidden=(32,), lr=3e-3)


def _clusters(seed, n_items=257, d=24):
    """Items in 8 latent clusters (tests/test_rqvae_pipeline.py's data)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)) * 3
    assign = rng.integers(0, 8, n_items)
    reprs = centers[assign] + 0.15 * rng.standard_normal((n_items, d))
    reprs[0] = 0
    return rng, assign, reprs


def _cluster_hit(top, assign, pos, n):
    return np.mean([assign[top[i]].tolist().count(assign[pos[i]]) / 10
                    for i in range(n)])


def test_semantic_id_pipeline_end_to_end():
    rng, assign, reprs = _clusters(0)
    n_items, d = reprs.shape
    rq = TT.train_rqvae(reprs.astype(np.float32), CFG, num_steps=400,
                        batch_size=128, device="cpu")
    assert rq.semantic_ids.shape == (n_items, 2)
    assert rq.semantic_ids.dtype == np.int32
    assert rq.final_losses["recon"] < 1.0

    # same-cluster items should share level-0 codes far above chance
    same = tot = 0
    for c in range(8):
        ids = np.nonzero(assign == c)[0]
        ids = ids[ids > 0]
        if len(ids) < 2:
            continue
        _, counts = np.unique(rq.semantic_ids[ids, 0], return_counts=True)
        same += counts.max()
        tot += len(ids)
    assert same / tot > 0.8

    # queries = noisy versions of their positive item's representation
    m = 512
    pos = rng.integers(1, n_items, m)
    queries = reprs[pos] + 0.1 * rng.standard_normal((m, d))
    head = TT.train_genret_head(rq, queries.astype(np.float32), pos, CFG,
                                num_steps=400, batch_size=256, device="cpu")
    q = queries[:64].astype(np.float32)
    top = TT.genret_retrieve(head["params"], rq, q, CFG, k=10, device="cpu")
    assert _cluster_hit(top, assign, pos, 64) > 0.5
    # true generative retrieval: beam decode, beams mapped to items
    top_b = TT.genret_retrieve(head["params"], rq, q, CFG, k=10,
                               method="beam", beam_width=16, device="cpu")
    assert _cluster_hit(top_b, assign, pos, 64) > 0.5
    top_f = TT.genret_retrieve(head["params"], rq, q, CFG, k=10,
                               method="flat", device="cpu")
    assert top_f.shape == (64, 10) and (top_f >= 1).all()


def test_beam_decode_consistency():
    """Beam scores agree with the exact scorer, come best-first, and the
    top beam is the joint argmax on a brute-forceable code space."""
    import itertools

    rng = np.random.default_rng(4)
    cfg = RQVAEConfig(num_levels=3, codebook_size=8, code_dim=4,
                      enc_hidden=(16,))
    gen = torch.Generator().manual_seed(0)
    rq = TR.init_rqvae_params(gen, cfg, input_dim=12)
    gp = TR.init_genret_params(gen, cfg, query_dim=12)

    def jitter(tree):
        return TR.tree_map(lambda x: x + 0.3 * torch.from_numpy(
            rng.standard_normal(tuple(x.shape)).astype(np.float32)), tree)

    gp = jitter(gp)
    q = torch.from_numpy(rng.standard_normal((5, 12)).astype(np.float32))
    W = 8
    codes, scores = TR.genret_beam_decode(gp, rq, q, cfg, beam_width=W)
    assert codes.shape == (5, W, 3) and scores.shape == (5, W)
    s = scores.numpy()
    assert (np.diff(s, axis=1) <= 1e-6).all()
    for b in range(5):
        exact = TR.genret_score_items_exact(gp, rq, q[b:b + 1], codes[b], cfg)
        np.testing.assert_allclose(s[b], exact.numpy()[0], rtol=1e-4,
                                   atol=1e-4)

    cfg2 = RQVAEConfig(num_levels=2, codebook_size=8, code_dim=4,
                       enc_hidden=(16,))
    rq2 = TR.init_rqvae_params(gen, cfg2, input_dim=12)
    gp2 = jitter(TR.init_genret_params(gen, cfg2, query_dim=12))
    _, scores2 = TR.genret_beam_decode(gp2, rq2, q, cfg2, beam_width=8)
    all_codes = torch.tensor(list(itertools.product(range(8), repeat=2)))
    full = TR.genret_score_items_exact(gp2, rq2, q, all_codes, cfg2).numpy()
    np.testing.assert_allclose(scores2.numpy()[:, 0], full.max(axis=1),
                               rtol=1e-5, atol=1e-5)


def _serving_dir(root, reprs, queries):
    """The serving corpus (row 0 dropped), retrieval ids offset so that
    ids differ from row indices."""
    res = root / "result"
    res.mkdir(parents=True, exist_ok=True)
    rid = np.arange(1, len(reprs), dtype=np.uint64) + 1000
    formats.save_emb(reprs[1:].astype(np.float32), res / "embedding.fbin")
    formats.save_emb(rid.reshape(-1, 1), res / "id.u64bin")
    formats.save_emb(queries, res / "query.fbin")
    return res, rid


def test_semantic_serving_file_contract(tmp_path):
    """--ann_method semantic on disk: artifacts saved by the cli.semantic
    helper, query.fbin / embedding.fbin / id.u64bin in, id100.u64bin of
    retrieval ids out, with the cluster quality of the in-memory beam
    retriever."""
    rng, assign, reprs = _clusters(7)
    n_items, d = reprs.shape
    rq = TT.train_rqvae(reprs.astype(np.float32), CFG, num_steps=400,
                        batch_size=128, device="cpu")
    m = 512
    pos = rng.integers(1, n_items, m)
    queries = (reprs[pos] + 0.1 * rng.standard_normal((m, d))).astype(
        np.float32)
    head = TT.train_genret_head(rq, queries, pos, CFG, num_steps=400,
                                batch_size=256, device="cpu")

    art = TSS.save_semantic_artifacts(tmp_path, rq.params, head["params"],
                                      CFG, input_dim=d, query_dim=d)
    assert art.exists()
    rq_l, head_l, cfg_l = TSS.load_semantic_artifacts(tmp_path)
    assert dataclasses.asdict(cfg_l) == dataclasses.asdict(CFG)
    for a, b in zip(TSS._leaves(rq_l), TSS._leaves(rq.params)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())

    res, rid = _serving_dir(tmp_path, reprs, queries[:64])
    out = TSS.run_semantic_ann(res, tmp_path, RetrievalConfig(top_k=10),
                               beam_width=16, device="cpu")
    got = formats.read_result_ids(out)
    assert got.shape == (64, 10)
    assert set(np.unique(got)) <= set(rid.tolist())
    hit = np.mean([assign[got[i] - 1000].tolist().count(assign[pos[i]]) / 10
                   for i in range(64)])
    assert hit > 0.5, hit


@pytest.fixture(scope="module")
def jax_trained():
    """A tokenizer and decode head the JAX package trained."""
    rng, assign, reprs = _clusters(3)
    n_items, d = reprs.shape
    rq = JT.train_rqvae(reprs.astype(np.float32), CFG, num_steps=400,
                        batch_size=128)
    m = 512
    pos = rng.integers(1, n_items, m)
    queries = (reprs[pos] + 0.1 * rng.standard_normal((m, d))).astype(
        np.float32)
    head = JT.train_genret_head(rq, queries, pos, CFG, num_steps=400,
                                batch_size=256)
    return rq, head["params"], reprs, queries


def _flat_np(tree):
    return [(p, a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
            for p, a in TSS._leaves(tree)]


def test_artifacts_load_across_packages(jax_trained, tmp_path):
    rq, head, reprs, _ = jax_trained
    d = reprs.shape[1]
    want = _flat_np({"rq": jax.tree.map(np.asarray, rq.params),
                     "head": jax.tree.map(np.asarray, head)})
    # JAX writes, the port reads
    JSS.save_semantic_artifacts(tmp_path / "j", rq.params, head, CFG,
                                input_dim=d, query_dim=d)
    t_rq, t_head, t_cfg = TSS.load_semantic_artifacts(tmp_path / "j")
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(CFG)
    assert isinstance(t_rq["enc"], list)
    got = _flat_np({"rq": t_rq, "head": t_head})
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)
    # the port writes (the same manifest paths and meta keys), JAX reads
    TSS.save_semantic_artifacts(tmp_path / "t", t_rq, t_head, t_cfg,
                                input_dim=d, query_dim=d)
    j_rq, j_head, j_cfg = JSS.load_semantic_artifacts(tmp_path / "t")
    assert dataclasses.asdict(j_cfg) == {**dataclasses.asdict(CFG),
                                         "enc_hidden": [32]}
    back = _flat_np({"rq": jax.tree.map(np.asarray, j_rq),
                     "head": jax.tree.map(np.asarray, j_head)})
    for (p, a), (_, b) in zip(back, want):
        np.testing.assert_array_equal(a, b, err_msg=p)
    import json
    jm = json.loads(next((tmp_path / "j" / "semantic").iterdir()).joinpath(
        "meta.json").read_text())
    tm = json.loads(next((tmp_path / "t" / "semantic").iterdir()).joinpath(
        "meta.json").read_text())
    assert tm == jm


@pytest.mark.parametrize("beam_width,corpus", [(16, "clusters"),
                                              (4, "spread")])
def test_serving_matches_jax(jax_trained, tmp_path, beam_width, corpus):
    """Both packages' run_semantic_ann on the same JAX-trained artifacts
    and result directory write the same id100.u64bin; a row may differ
    only where the two packages' beams score within 1e-5 of each other.
    On the clustered corpus the beams cover every row; the spread corpus
    (items the tokenizer never saw, few sharing an id) leaves rows short
    of 10 items, which the exact scorer fills through its ties."""
    rq, head, reprs, queries = jax_trained
    d = reprs.shape[1]
    if corpus == "spread":
        reprs = np.random.default_rng(5).standard_normal(
            reprs.shape).astype(np.float32) * 3
    JSS.save_semantic_artifacts(tmp_path, rq.params, head, CFG,
                                input_dim=d, query_dim=d)
    res, _ = _serving_dir(tmp_path, reprs, queries[:96])
    cfg = RetrievalConfig(top_k=10)
    j = formats.read_result_ids(JSS.run_semantic_ann(
        res, tmp_path, cfg, beam_width=beam_width,
        result_file="id100_jax.u64bin"))
    t = formats.read_result_ids(TSS.run_semantic_ann(
        res, tmp_path, cfg, beam_width=beam_width,
        result_file="id100.u64bin", device="cpu"))
    assert t.shape == j.shape == (96, 10)

    rq_t = tree_from_jax(jax.tree.map(np.asarray, rq.params))
    head_t = tree_from_jax(jax.tree.map(np.asarray, head))
    q = torch.from_numpy(queries[:96])
    bc, ts = TR.genret_beam_decode(head_t, rq_t, q, CFG, beam_width)
    codes = TR.tokenize(rq_t, torch.from_numpy(
        reprs[1:].astype(np.float32))).numpy()
    short = (TR.beam_retrieve(bc.numpy(), ts.numpy(), codes, 10) < 0).any(1)
    assert short.sum() > (48 if corpus == "spread" else -1), short.sum()

    differ = np.nonzero((np.asarray(t) != np.asarray(j)).any(1))[0]
    if len(differ):
        _, js = JR.genret_beam_decode(head, rq.params,
                                      jnp.asarray(queries[differ]), CFG,
                                      beam_width)
        np.testing.assert_allclose(ts.numpy()[differ], np.asarray(js),
                                   rtol=0, atol=1e-5)
    assert len(differ) <= 2, differ
