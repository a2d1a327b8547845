"""The port's sampled softmax (tencent_recommendation_2025_tpu_torch/ops/
losses.py) against the JAX package's on the CPU: logQ correction,
accidental hits and id-0 candidates masked, a given per-candidate logQ,
the gradient, and the in-batch candidates with their indices given (the
JAX package draws them with jax.random, which torch cannot reproduce)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.ops import losses as JL
from tencent_recommendation_2025_tpu_torch.ops import losses as TL

B, L, D, N = 3, 7, 8, 12


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, D)).astype(np.float32)
    pos = rng.standard_normal((B, L, D)).astype(np.float32)
    negs = rng.standard_normal((N, D)).astype(np.float32)
    pos_ids = rng.integers(1, 20, (B, L)).astype(np.int32)
    neg_ids = rng.integers(1, 20, N).astype(np.int32)
    neg_ids[:3] = pos_ids[0, :3]          # accidental hits
    neg_ids[3] = 0                        # an empty in-batch slot
    neg_ids[4] = -1
    mask = rng.random((B, L)) > 0.3
    logq = (rng.standard_normal(N) * 0.5 - 3).astype(np.float32)
    return q, pos, negs, neg_ids, pos_ids, mask, logq


@pytest.mark.parametrize("given_logq", [False, True])
def test_sampled_softmax_matches_jax(given_logq):
    q, pos, negs, neg_ids, pos_ids, mask, logq = _inputs(0)
    lq = logq if given_logq else None

    def jloss(q, pos, negs):
        return JL.sampled_softmax_loss(
            q, pos, negs, jnp.asarray(neg_ids), jnp.asarray(pos_ids),
            jnp.asarray(mask), 1000, temperature=0.7,
            neg_logq=None if lq is None else jnp.asarray(lq))

    want, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(pos), jnp.asarray(negs))
    tq, tp, tn = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, pos, negs))
    got = TL.sampled_softmax_loss(
        tq, tp, tn, torch.from_numpy(neg_ids), torch.from_numpy(pos_ids),
        torch.from_numpy(mask), 1000, temperature=0.7,
        neg_logq=None if lq is None else torch.from_numpy(lq))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for t, g in zip((tq, tp, tn), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_sampled_softmax_masks_hits_and_empty_slots():
    """An empty candidate slot (id <= 0) takes no part: moving its
    embedding leaves the loss as it was; no masked position, loss 0."""
    q, pos, negs, neg_ids, pos_ids, mask, _ = _inputs(1)

    def run(negs):
        return TL.sampled_softmax_loss(
            torch.from_numpy(q), torch.from_numpy(pos),
            torch.from_numpy(negs), torch.from_numpy(neg_ids),
            torch.from_numpy(pos_ids), torch.from_numpy(mask), 1000).item()

    moved = negs.copy()
    moved[3:5] += 100.0                   # the id 0 and id -1 slots
    assert run(moved) == run(negs)
    empty = TL.sampled_softmax_loss(
        torch.from_numpy(q), torch.from_numpy(pos), torch.from_numpy(negs),
        torch.from_numpy(neg_ids), torch.from_numpy(pos_ids),
        torch.zeros((B, L), dtype=torch.bool), 1000)
    assert empty.item() == 0.0


def test_inbatch_candidates_match_jax():
    """With the JAX draw's indices given, ids, embeddings and the empirical
    logQ agree; draws on invalid positions give id 0."""
    q, pos, _, _, pos_ids, mask, _ = _inputs(2)
    pos_ids[1] = pos_ids[0]               # repeated positives: counts > 1
    key = jax.random.key(5)
    want = JL.inbatch_candidates(jnp.asarray(pos_ids), jnp.asarray(pos),
                                 jnp.asarray(mask), 16, key)
    idx = jax.random.randint(key, (16,), 0, B * L)
    got = TL.inbatch_candidates(torch.from_numpy(pos_ids),
                                torch.from_numpy(pos),
                                torch.from_numpy(mask), 16,
                                idx=torch.from_numpy(np.array(idx)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert (got[0] == 0).any()
    drawn = TL.inbatch_candidates(torch.from_numpy(pos_ids),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(mask), 16,
                                  gen=torch.Generator().manual_seed(0))
    assert drawn[0].shape == (16,) and drawn[1].shape == (16, D)
