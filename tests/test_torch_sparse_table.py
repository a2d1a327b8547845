"""The port's sparse-table ops (tencent_recommendation_2025_tpu_torch/ops/
sparse_table.py) against the JAX package's on the CPU: the gathered-row
lookups, the row optimizers, the host plans, and the plain versions of the
group-scatter and group-gather kernels against the JAX Pallas kernels in
interpret mode. The CUDA kernels are held to these plain versions on the
card (chip_smoke.py, tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tencent_recommendation_2025_tpu.ops import sparse_table as JST
from tencent_recommendation_2025_tpu_torch.ops import sparse_table as TST

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _uids(rng, V, n_real, K):
    """Sorted unique real ids with the sentinel V tail, length K."""
    u = np.full((K,), V, np.int32)
    u[:n_real] = np.sort(rng.choice(V, size=n_real, replace=False))
    return u


@pytest.mark.parametrize("site", [None, "seq"])
def test_gathered_rows_lookup_matches_jax(site):
    """Plan path and searchsorted path, forward and the rows' gradient."""
    rng = np.random.default_rng(0)
    V, D, K = 300, 8, 40
    uids = _uids(rng, V, 30, K)
    rows = rng.standard_normal((K, D)).astype(np.float32)
    ids = np.where(rng.random((3, 17)) < 0.8,
                   uids[rng.integers(0, 30, (3, 17))], 0).astype(np.int32)
    plan = JST.build_lookup_plan(uids, ids)
    cot = rng.standard_normal((3, 17, D)).astype(np.float32)
    jplans = {"seq": {k: jnp.asarray(v) for k, v in plan.items()}}
    jr = JST.GatheredRows(jnp.asarray(uids), jnp.asarray(rows), jplans)

    def f(r):
        return (JST.GatheredRows(jr.uids, r, jr.plans).lookup(
            jnp.asarray(ids), site=site) * cot).sum()

    want, jgrad = jax.value_and_grad(f)(jnp.asarray(rows))
    tr = _t(rows).requires_grad_(True)
    tplans = {"seq": {k: _t(v) for k, v in plan.items()}}
    got = TST.GatheredRows(_t(uids), tr, tplans).lookup(_t(ids), site=site)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jr.lookup(jnp.asarray(ids), site=site)), rtol=1e-6)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)
    assert TST.build_lookup_plan(uids, ids).keys() == plan.keys()
    for k, v in TST.build_lookup_plan(uids, ids).items():
        np.testing.assert_array_equal(v, plan[k])


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["lazy_adam", "rowwise_adagrad"])
def test_compute_row_update_matches_jax(kind, table_dtype):
    """Row math of both optimizers at step 3, weight decay on, sentinel
    rows masked; f32 agrees to 1e-6, and so does a bf16 table (new rows cast
    to bf16 at the end, as the JAX package does)."""
    rng = np.random.default_rng(1)
    V, D, K = 200, 16, 48
    uids = _uids(rng, V, 40, K)
    table = rng.standard_normal((V, D)).astype(np.float32)
    drows = rng.standard_normal((K, D)).astype(np.float32)
    jt = jnp.asarray(table, table_dtype)
    tt = _t(table).to(getattr(torch, table_dtype))
    if kind == "lazy_adam":
        mu = rng.standard_normal((V, D)).astype(np.float32) * 0.1
        nu = rng.random((V, D)).astype(np.float32) * 0.01
        jopt = {"mu": jnp.asarray(mu), "nu": jnp.asarray(nu)}
        topt = {"mu": _t(mu), "nu": _t(nu)}
    else:
        acc = rng.random(V).astype(np.float32)
        jopt, topt = {"acc": jnp.asarray(acc)}, {"acc": _t(acc)}
    kw = dict(kind=kind, lr=5e-3, b1=0.9, b2=0.98, weight_decay=0.01)
    jrows, jo = JST.compute_row_update(jt, jopt, jnp.asarray(uids),
                                       jnp.asarray(drows),
                                       step=jnp.asarray(3), **kw)
    trows, to = TST.compute_row_update(tt, topt, _t(uids), _t(drows),
                                       step=3, **kw)
    assert trows.dtype == tt.dtype
    np.testing.assert_allclose(trows.float().numpy(),
                               np.asarray(jrows, np.float32), rtol=1e-6,
                               atol=1e-7)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_host_plans_match_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 5000, 3000)
    for cap in (4000, 1000):          # room to spare, and a cut
        np.testing.assert_array_equal(
            TST.host_unique_touched(ids, cap, 5000),
            JST.host_unique_touched(ids, cap, 5000))
    V, R = 64 * 512, 16
    uids = _uids(rng, V, 1500, 1536)
    got, want = TST.host_group_plan(uids, V, R), JST.host_group_plan(uids, V,
                                                                     R)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for rows in (100, 29_999_999, 30_000_001, 100_000_001):
        assert TST.padded_table_rows(rows) == JST.padded_table_rows(rows)
        for dim in (64, 48):
            assert TST.is_packed_scale(rows, dim) == \
                (JST.packed_table_shape(rows, dim) is not None)
    for dim in (16, 64, 128, 48, 256):
        assert TST.scatter_group_rows(dim) == JST.scatter_group_rows(None,
                                                                     dim)


def _scatter_case(rng, nG, dtype, n_real, K=1024):
    R, D = 16, 64
    table = rng.standard_normal((nG * R, D)).astype(np.float32)
    groups = np.full((K,), nG, np.int32)
    groups[:n_real] = rng.choice(nG, size=n_real, replace=False)
    arranged = rng.standard_normal((K, R * D)).astype(np.float32)
    jtab = jnp.asarray(table, dtype).reshape(nG, 8, 128)
    ttab = _t(table).to(getattr(torch, dtype))
    return table, groups, arranged, jtab, ttab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_scatter_plain_matches_pallas(dtype):
    """In place, sentinel groups skipped: bitwise equal to the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(3)
    nG = 64
    _, groups, arranged, jtab, ttab = _scatter_case(rng, nG, dtype, 20)
    want = JST.pallas_group_scatter(
        jtab, jnp.asarray(groups),
        jnp.asarray(arranged, dtype).reshape(-1, 8, 128), interpret=True)
    view = TST.group_view(ttab, 16)
    ptr = view.data_ptr()
    got = TST.group_scatter(view, _t(groups),
                            _t(arranged).to(getattr(torch, dtype)))
    assert got.data_ptr() == ptr == ttab.data_ptr()
    np.testing.assert_array_equal(
        ttab.view(-1, 8, 128).float().numpy(),
        np.asarray(want, np.float32))


def test_group_gather_plain_matches_pallas():
    rng = np.random.default_rng(4)
    _, groups, _, jtab, ttab = _scatter_case(rng, 64, "float32", 20)
    want = np.asarray(JST.pallas_group_gather(jtab, jnp.asarray(groups),
                                              interpret=True))
    got = TST.group_gather(TST.group_view(ttab, 16), _t(groups)).numpy()
    np.testing.assert_array_equal(got[:20], want[:20].reshape(20, -1))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_group_gather_plain_matches_pallas_interleaved(dtype):
    """Unsorted real groups with sentinel slots between them (the slot
    order the card's kernel is held to in chip_smoke.py and the card
    tests): every real slot's row bitwise equal to the Pallas kernel's in
    interpret mode; the sentinel rows are zero in the plain version (the
    kernels leave them unwritten)."""
    rng = np.random.default_rng(5)
    nG, K = 96, 1024
    table, _, _, jtab, ttab = _scatter_case(rng, nG, dtype, 0, K)
    groups = np.full((K,), nG, np.int32)
    slots = np.sort(rng.choice(K, size=60, replace=False))
    groups[slots] = rng.choice(nG, size=60, replace=False)
    assert (np.diff(groups[slots]) < 0).any() and slots[-1] < K - 1
    want = np.asarray(JST.pallas_group_gather(jtab, jnp.asarray(groups),
                                              interpret=True), np.float32)
    got = TST.group_gather(TST.group_view(ttab, 16), _t(groups))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got[slots].float().numpy(),
                                  want[slots].reshape(60, -1))
    assert not got[np.setdiff1d(np.arange(K), slots)].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_scatter_apply_across_chunks(monkeypatch, dtype):
    """The chunked merge (one scatter per chunk of 1024 groups, both
    packages patched) equals the JAX one and a plain row write."""
    monkeypatch.setattr(JST, "_SCATTER_CHUNK_GROUPS", 1024)
    monkeypatch.setattr(TST, "_SCATTER_CHUNK_GROUPS", 1024)
    rng = np.random.default_rng(5)
    V, D = 64 * 512, 64
    R = TST.scatter_group_rows(D)
    table = rng.standard_normal((V, D)).astype(np.float32)
    uids = _uids(rng, V, 1500, 1536)
    vals = rng.standard_normal((len(uids), D)).astype(np.float32)
    jplan = {k: jnp.asarray(v)
             for k, v in JST.host_group_plan(uids, V, R).items()}
    assert jplan["groups"].shape[0] > 1024
    want = JST.group_scatter_apply(
        jnp.asarray(table, dtype).reshape(V // R, 8, 128),
        jnp.asarray(vals, dtype), jplan, use_pallas=True, interpret=True)
    tplan = {k: _t(v) for k, v in TST.host_group_plan(uids, V, R).items()}
    ttab = _t(table).to(getattr(torch, dtype))
    got = TST.group_scatter_apply(ttab, _t(vals), tplan)
    assert got is ttab
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32).reshape(V, D))
    ref = _t(table).to(getattr(torch, dtype))
    real = uids < V
    ref[_t(uids[real]).long()] = _t(vals[real]).to(ref.dtype)
    assert torch.equal(got, ref)


def test_grouped_gather_and_write_back_roundtrip():
    """gather_rows_grouped gives gather_rows' rows, and the write-back that
    reuses its group buffer equals a row write."""
    rng = np.random.default_rng(6)
    V, D = 1024, 64
    table = _t(rng.standard_normal((V, D)).astype(np.float32))
    uids = _uids(rng, V, 23, 40)
    plan = {k: _t(v) for k, v in TST.host_group_plan(uids, V, 16).items()}
    gathered, buf = TST.gather_rows_grouped(table, _t(uids), plan, D)
    assert torch.equal(gathered.rows, TST.gather_rows(table, _t(uids)).rows)
    vals = _t(rng.standard_normal((40, D)).astype(np.float32))
    ref = table.clone()
    ref[_t(uids[:23]).long()] = vals[:23]
    TST.group_scatter_apply(table, vals, plan, old=buf)
    assert torch.equal(table, ref)


def test_scatter_row_update_drops_sentinels():
    """Without a group plan, 1-D state and tables take a row write of the
    real uids only."""
    V, D = 10, 4
    table, acc = torch.zeros((V, D)), torch.zeros(V)
    uids = torch.tensor([1, 4, V, V], dtype=torch.int32)
    rows = torch.arange(16, dtype=torch.float32).reshape(4, D)
    TST.scatter_row_update(table, {"acc": acc}, uids, rows,
                           {"acc": torch.tensor([1.0, 2.0, 3.0, 4.0])})
    assert torch.equal(table[1], rows[0]) and torch.equal(table[4], rows[1])
    assert table.abs().sum() == rows[:2].abs().sum()
    assert acc.tolist() == [0, 1, 0, 0, 2, 0, 0, 0, 0, 0]
