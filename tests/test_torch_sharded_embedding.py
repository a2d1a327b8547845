"""Row-sharded table lookups (tencent_recommendation_2025_tpu_torch/parallel/
sharded_embedding.py) against the JAX package's on the same numpy arrays:
``sharded_lookup`` and the all-to-all ``sharded_lookup_a2a``, forward and
table gradient, on JAX data meshes of the 8 fake CPU devices of conftest.py
(tests/test_parallel.py:32, 43, 64, 76), and the a2a's overflow count
(tests/test_parallel.py:100): capacity_factor 0.125 against 8.0, the same
count as JAX's, the overflowed ids' rows zero and their gradients zero.

The port runs each case on a local mesh (data 8 and 4: every data shard's
rows in turn in this process) and on gloo process meshes of 2 and 4
processes (each the worker of this file run as a script, holding its block
of the table and its block of the batch rows). Tolerances: the forward at
rtol 1e-6 (tests/test_parallel.py's), the table gradient at rtol 1e-5 /
atol 1e-6.

Also the mesh's collectives over the data group: a local mesh's over its
list of shards against gloo's (outputs and autograd transposes), and
``ep_overflow_scope``: two threads collect only their own counts and
nesting restores the outer scope (tests/test_parallel.py:268)."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 120
GROUPS = (2, 4)
LOCAL = (8, 4)

#: name -> (V, D, ids shape, ids seed, cotangent seed, lookup, factor)
CASES = {
    "lookup": (50, 8, (8, 5), 0, 1, "lookup", None),
    "lookup_grad": (37, 4, (8, 3), 1, 11, "lookup", None),
    "a2a": (64, 8, (16, 4), 5, 15, "a2a", 8.0),
    "overflow": (64, 8, (8, 8), 6, 16, "a2a", 0.125),
    "overflow_ample": (64, 8, (8, 8), 6, 16, "a2a", 8.0),
}


def _arrays(name):
    """The case's table, ids and cotangent (numpy, from its seeds); the
    overflow cases put every id on shard 0's row 1."""
    V, D, shape, seed, cseed, _, _ = CASES[name]
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, shape).astype(np.int32)
    if name.startswith("overflow"):
        ids = np.full(shape, 1, np.int32)
    cot = np.random.default_rng(cseed).standard_normal(
        shape + (D,)).astype(np.float32)
    return table, ids, cot


def _port_case(name, mesh):
    """(this process's output rows, the table gradient, the overflow count
    or -1) of case ``name`` on ``mesh``: a local mesh runs every data
    shard's rows; a process mesh its own, and its gradient is nonzero on
    its block of rows only."""
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as SE
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import data_rows

    table, ids, cot = _arrays(name)
    _, _, _, _, _, kind, factor = CASES[name]
    t = torch.tensor(table, requires_grad=True)
    st = SE.shard_table(mesh, t)
    S = mesh.shape["data"]
    B = ids.shape[0]
    outs, count = [], torch.zeros((), dtype=torch.int64)
    for d in mesh.data_indices:
        rows = data_rows(B, S, d)
        x = torch.from_numpy(ids[rows])
        if kind == "lookup":
            out = SE.sharded_lookup(mesh, st, x)
        else:
            out, n = SE.sharded_lookup_a2a(mesh, st, x,
                                           capacity_factor=factor,
                                           return_overflow=True, sender=d)
            count = count + n
        (out * torch.from_numpy(cot[rows])).sum().backward(
            retain_graph=True)
        outs.append(out.detach())
    return (torch.cat(outs).numpy(), t.grad.numpy(),
            int(count) if kind == "a2a" else -1)


_JAX = {}


def _jax_case(name, S):
    """(output, table gradient, overflow count or -1) of the JAX package on
    a data mesh of S of the fake devices."""
    key = (name, S)
    if key in _JAX:
        return _JAX[key]
    import jax
    import jax.numpy as jnp

    from tencent_recommendation_2025_tpu.config import MeshConfig
    from tencent_recommendation_2025_tpu.parallel import mesh as M
    from tencent_recommendation_2025_tpu.parallel import \
        sharded_embedding as SE

    if jax.device_count() < S:
        pytest.skip(f"needs {S} fake devices")
    table, ids, cot = _arrays(name)
    _, _, _, _, _, kind, factor = CASES[name]
    mesh = M.build_mesh(MeshConfig(data=S, model=1, seq=1),
                        devices=jax.devices()[:S])
    jids, jcot = jnp.asarray(ids), jnp.asarray(cot)

    def f(t):
        if kind == "lookup":
            return SE.sharded_lookup(mesh, t, jids), jnp.int32(-1)
        return SE.sharded_lookup_a2a(mesh, t, jids, capacity_factor=factor,
                                     return_overflow=True)

    def loss(t):
        out, n = f(t)
        return (out * jcot).sum(), (out, n)

    g, (out, n) = jax.grad(loss, has_aux=True)(jnp.asarray(table))
    V = table.shape[0]
    _JAX[key] = (np.asarray(out), np.asarray(g)[:V], int(n))
    return _JAX[key]


def _check(name, got, want, rows=slice(None), block=None):
    """``got`` (output rows, gradient, count) against JAX's ``want``: the
    rows ``rows`` of its output; the gradient in full, or within ``block``
    of the table's rows (zero elsewhere)."""
    out, g, n = got
    wout, wg, wn = want
    np.testing.assert_allclose(out, wout[rows], rtol=1e-6, atol=0)
    if block is not None:
        mask = np.zeros(wg.shape[0], bool)
        mask[block] = True
        assert not g[~mask].any()
        wg = np.where(mask[:, None], wg, 0.0)
    np.testing.assert_allclose(g, wg, rtol=1e-5, atol=1e-6)
    assert n == wn


# ---------------------------------------------------------------------------
# the worker: one process of a group, run as a script
# ---------------------------------------------------------------------------

def _collectives(mesh, S):
    """Each data shard's outputs of the three collectives over its input
    [S * 3, 2] (shard d's is (d + 1) * arange), and the inputs' gradients
    of a loss weighting every output by a seeded shard's own weights: the
    shards this process holds (one on a process mesh)."""
    xs = [(torch.arange(S * 6, dtype=torch.float32).reshape(S * 3, 2)
           * (d + 1)).requires_grad_(True) for d in mesh.data_indices]
    outs = {"gather": mesh.all_gather(xs), "scatter": mesh.reduce_scatter(xs),
            "a2a": mesh.all_to_all(xs)}
    loss = 0.0
    for k, parts in outs.items():
        for d, t in zip(mesh.data_indices, parts):
            w = torch.from_numpy(np.random.default_rng(
                [d, len(k)]).standard_normal(tuple(t.shape)).astype(
                    np.float32))
            loss = loss + (t * w).sum()
    loss.backward()
    res = {f"{k}:{d}": t.detach().numpy() for k, parts in outs.items()
           for d, t in zip(mesh.data_indices, parts)}
    res.update({f"grad:{d}": x.grad.numpy()
                for d, x in zip(mesh.data_indices, xs)})
    return res


def _worker(out_dir):
    import torch.distributed as dist

    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import (
        build_mesh, initialize_distributed)

    torch.set_num_threads(1)
    initialize_distributed("cpu")
    mesh = build_mesh(MeshConfig())
    res = {f"coll:{k}": v for k, v in _collectives(
        mesh, mesh.shape["data"]).items()}
    for name in CASES:
        out, g, n = _port_case(name, mesh)
        res.update({f"{name}:out": out, f"{name}:grad": g,
                    f"{name}:count": np.int64(n)})
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n, out_dir):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(out_dir)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, time.monotonic()


def _wait(group):
    procs, t0 = group
    outs = []
    for p in procs:
        left = max(1.0, GROUP_TIMEOUT - (time.monotonic() - t0))
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"process group exceeded {GROUP_TIMEOUT} s")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The gloo groups of 2 and 4 processes, started at once."""
    root = tmp_path_factory.mktemp("sharded_embedding")
    started = {}
    for n in GROUPS:
        (root / str(n)).mkdir()
        started[n] = _start(n, root / str(n))
    return started, root, set()


def _results(groups, n):
    started, root, done = groups
    if n not in done:
        _wait(started[n])
        done.add(n)
    return root / str(n)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", LOCAL)
@pytest.mark.parametrize("name", sorted(CASES))
def test_local_mesh_lookup_matches_jax(name, S):
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    got = _port_case(name, local_mesh(MeshConfig(data=S)))
    want = _jax_case(name, S)
    _check(name, got, want)
    if name == "overflow":
        # every id past its bucket returned a zero row and no gradient
        assert want[2] > 0
        out = got[0].reshape(-1, got[0].shape[-1])
        assert (~out.any(-1)).sum() >= want[2]


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_process_mesh_lookup_matches_jax(groups, name, n):
    """Each rank's output rows, its block of the table gradient and the
    global overflow count equal JAX's on a data mesh of n devices."""
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import data_rows

    out_dir = _results(groups, n)
    want = _jax_case(name, n)
    V = _arrays(name)[0].shape[0]
    rps = -(-V // n)
    B = _arrays(name)[1].shape[0]
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        got = (r[f"{name}:out"], r[f"{name}:grad"], int(r[f"{name}:count"]))
        _check(name, got, want, rows=data_rows(B, n, rank),
               block=slice(rank * rps, (rank + 1) * rps))


@pytest.mark.parametrize("n", GROUPS)
def test_local_mesh_collectives_match_the_process_groups(groups, n):
    """A local mesh's all_gather, reduce_scatter and all_to_all over its
    list of shards give each shard what gloo's give each rank, and their
    backward (autograd over the list; the process mesh's transposes:
    reduce-scatter, all-gather, the reverse exchange) the same gradients."""
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    out_dir = _results(groups, n)
    local = _collectives(local_mesh(MeshConfig(data=n)), n)
    for rank in range(n):
        r = np.load(out_dir / f"rank{rank}.npz")
        for k in ("gather", "scatter", "a2a", "grad"):
            # the gradient's sums of 4 terms in another order: atol
            np.testing.assert_allclose(r[f"coll:{k}:{rank}"],
                                       local[f"{k}:{rank}"], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_a2a_overflow_count_depends_on_capacity():
    """At ample capacity no id overflows and the a2a equals the plain
    lookup; at 1/8 of it the count is positive (tests/test_parallel.py:100)
    on the port alone, as the JAX cases above hold the numbers."""
    from tencent_recommendation_2025_tpu_torch.config import MeshConfig
    from tencent_recommendation_2025_tpu_torch.parallel import \
        sharded_embedding as SE
    from tencent_recommendation_2025_tpu_torch.parallel.mesh import \
        local_mesh

    table, ids, _ = _arrays("overflow")
    mesh = local_mesh(MeshConfig(data=8))
    st = SE.shard_table(mesh, torch.from_numpy(table))
    counts = {}
    for f in (0.125, 8.0):
        outs, n = [], 0
        for d in range(8):
            out, c = SE.sharded_lookup_a2a(
                mesh, st, torch.from_numpy(ids[d:d + 1]), capacity_factor=f,
                return_overflow=True, sender=d)
            outs.append(out)
            n += int(c)
        counts[f] = (torch.cat(outs), n)
    assert counts[0.125][1] > 0 and counts[8.0][1] == 0
    np.testing.assert_array_equal(
        counts[8.0][0].numpy(),
        SE.dense_lookup_oracle(torch.from_numpy(table),
                               torch.from_numpy(ids)).numpy())


def test_ep_overflow_scope_isolates_interleaved_threads():
    """Two threads inside their own scopes each collect only their own
    counts; nesting saves and restores the outer scope."""
    import threading
    import time as _t

    from tencent_recommendation_2025_tpu_torch.models.baseline import (
        _EP_OVERFLOW_ACC, ep_overflow_scope)

    results = {}
    barrier = threading.Barrier(2)

    def worker(name, value, delay):
        with ep_overflow_scope() as scope:
            barrier.wait()
            _t.sleep(delay)
            _EP_OVERFLOW_ACC.get().append(value)
            _t.sleep(0.05 - delay)
            results[name] = list(scope.counts)

    ts = [threading.Thread(target=worker, args=("a", 1, 0.0)),
          threading.Thread(target=worker, args=("b", 2, 0.02))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert results == {"a": [1], "b": [2]}
    with ep_overflow_scope() as outer:
        _EP_OVERFLOW_ACC.get().append(10)
        with ep_overflow_scope() as inner:
            _EP_OVERFLOW_ACC.get().append(20)
        _EP_OVERFLOW_ACC.get().append(30)
    assert outer.counts == [10, 30] and inner.counts == [20]
    assert _EP_OVERFLOW_ACC.get() is None


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1])
