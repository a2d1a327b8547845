"""Pipeline parallelism (tencent_recommendation_2025_tpu_torch/parallel/
pipeline_parallel.py, models/encoder.py) against the JAX package on the 8
fake CPU devices of conftest.py, on the JAX cases' own arrays:

- ``pipelined_scan`` on a local mesh against the JAX ``pipelined_scan``
  (tests/test_pipeline_parallel.py:35 S=4 M=8, :50 a dict activation with
  ``tt``, :71 pipe 2 x data 2, :88 the gradients): forward rtol 1e-5 /
  atol 1e-6, gradients rtol 1e-4 / atol 1e-6;
- ``encode`` on a pipe-2 local mesh against the JAX ``encode`` on a pipe-2
  mesh: the dense route (:113, rtol 1e-5 / atol 1e-5) and the fused route
  (:137: the port's plain version of the fused kernels, the JAX interpret
  mode with its gate patched open in this test; rtol 1e-4 / atol 1e-5);
- the schedule's shape checks, with the JAX messages; the dropout masks of
  two microbatches of identical rows differ (the fault the JAX package's
  ADVICE r4 fix repaired by folding the microbatch into the keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tencent_recommendation_2025_tpu.parallel.pipeline_parallel import \
    pipelined_scan as jax_pipelined_scan
from tencent_recommendation_2025_tpu_torch.bridge import params_from_jax
from tencent_recommendation_2025_tpu_torch.parallel.mesh import LocalMesh
from tencent_recommendation_2025_tpu_torch.parallel.pipeline_parallel import \
    pipelined_scan

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 fake devices")


def _blocks_and_x(NB, B, D, seed=0):
    # the JAX test's draws (tests/test_pipeline_parallel.py:17)
    rng = np.random.default_rng(seed)
    blocks = {"w": (rng.standard_normal((NB, D, D)) * 0.1).astype(np.float32),
              "b": (rng.standard_normal((NB, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((B, D)).astype(np.float32)
    return blocks, x


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jfn(a, bp):
    return jnp.tanh(a @ bp["w"] + bp["b"])


def _tfn(a, bp):
    return torch.tanh(a @ bp["w"] + bp["b"])


@requires_8
@pytest.mark.parametrize("case", ["s4_m8", "pipe2_data2"])
def test_pipelined_scan_matches_jax(case):
    """:35 (4 stages, 8 microbatches) and :71 (pipe 2 x data 2, 4
    microbatches a data column)."""
    if case == "s4_m8":
        NB, B, D, M, seed, shape = 8, 16, 32, 8, 0, (4,)
        jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("pipe",))
        kw, mesh = {}, LocalMesh(pipe=4)
    else:
        NB, B, D, M, seed, shape = 4, 16, 32, 4, 4, (2, 2)
        jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                     ("pipe", "data"))
        kw, mesh = {"data_axis": "data"}, LocalMesh(pipe=2, data=2)
    blocks, x = _blocks_and_x(NB, B, D, seed)
    want = jax_pipelined_scan(jmesh, "pipe", _jfn, _jax(blocks),
                              jnp.asarray(x), num_microbatches=M, **kw)
    got = pipelined_scan(mesh, _tfn, _torch(blocks), torch.from_numpy(x),
                         M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@requires_8
def test_pipelined_scan_dict_activation_matches_jax():
    """:50: the token types ride the conveyor with the hidden states."""
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("pipe",))
    blocks, x = _blocks_and_x(NB=4, B=8, D=16, seed=2)
    tt = np.random.default_rng(3).integers(0, 2, (8, 16)).astype(np.int32)

    def jfn(act, bp):
        m = (act["tt"] != 0).astype(jnp.float32)
        return {"x": jnp.tanh(act["x"] @ bp["w"] + bp["b"]) * m,
                "tt": act["tt"]}

    def tfn(act, bp):
        m = (act["tt"] != 0).float()
        return {"x": torch.tanh(act["x"] @ bp["w"] + bp["b"]) * m,
                "tt": act["tt"]}

    want = jax_pipelined_scan(jmesh, "pipe", jfn, _jax(blocks),
                              {"x": jnp.asarray(x), "tt": jnp.asarray(tt)},
                              num_microbatches=4)
    got = pipelined_scan(LocalMesh(pipe=4), tfn, _torch(blocks),
                         {"x": torch.from_numpy(x),
                          "tt": torch.from_numpy(tt)}, 4)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["tt"].numpy(), tt)


@requires_8
def test_pipelined_scan_gradients_match_jax():
    """:88: the gradients flow through the whole schedule."""
    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("pipe",))
    rng = np.random.default_rng(1)
    NB, B, D = 4, 8, 16
    w = (rng.standard_normal((NB, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)

    def jloss(blocks):
        return jax_pipelined_scan(jmesh, "pipe",
                                  lambda a, bp: jnp.tanh(a @ bp["w"]),
                                  blocks, jnp.asarray(x),
                                  num_microbatches=4).sum()

    want = jax.grad(jloss)({"w": jnp.asarray(w)})["w"]
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    pipelined_scan(LocalMesh(pipe=2), lambda a, bp: torch.tanh(a @ bp["w"]),
                   {"w": tw}, tx, 4).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    jgx = jax.grad(lambda xx: jax_pipelined_scan(
        jmesh, "pipe", lambda a, bp: jnp.tanh(a @ bp["w"]),
        {"w": jnp.asarray(w)}, xx, num_microbatches=4).sum())(
            jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)


def test_pipelined_scan_shape_checks():
    """The JAX function's asserts, with its messages."""
    blocks, x = _blocks_and_x(NB=4, B=8, D=4)
    with pytest.raises(AssertionError, match="not divisible by stages"):
        pipelined_scan(LocalMesh(pipe=2), _tfn, _torch(blocks),
                       torch.from_numpy(x), 3)
    with pytest.raises(AssertionError, match="not divisible by microbatches"):
        pipelined_scan(LocalMesh(pipe=2), _tfn, _torch(blocks),
                       torch.from_numpy(x), 16)


def test_pipe_with_model_or_seq_raises_value_error():
    """JAX ``build_mesh``: pipe > 1 composes with data only."""
    for kw in (dict(model=2), dict(seq=2)):
        with pytest.raises(ValueError, match="model=seq=1"):
            LocalMesh(pipe=2, **kw)


# ---------------------------------------------------------------------------
# the encoder on a pipe mesh
# ---------------------------------------------------------------------------

def _encode_pair(cfg_kw, B, seed=5):
    from tencent_recommendation_2025_tpu.config import ModelConfig as JMC
    from tencent_recommendation_2025_tpu.models import encoder as JENC
    from tencent_recommendation_2025_tpu_torch.config import ModelConfig

    jcfg, cfg = JMC(**cfg_kw), ModelConfig(**cfg_kw)
    jparams = JENC.init_encoder_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(seed)
    L, D = cfg.maxlen + 1, cfg.hidden_units
    pos = (rng.standard_normal((L + 1, D)) * 0.1).astype(np.float32)
    emb = rng.standard_normal((B, L, D)).astype(np.float32)
    ids = rng.integers(1, 50, (B, L)).astype(np.int32)
    tt = np.ones((B, L), np.int32)
    tt[0, :9] = 0
    tt[1, :3] = 0
    return jcfg, cfg, jparams, pos, emb, ids, tt


def _port_encode(cfg, jparams, pos, emb, ids, tt, mesh, route):
    from tencent_recommendation_2025_tpu_torch.models import encoder as TENC

    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return TENC.encode(params, torch.from_numpy(emb), torch.from_numpy(ids),
                       torch.from_numpy(tt), torch.from_numpy(pos), cfg,
                       mesh=mesh, route=route)


@requires_8
@pytest.mark.parametrize("M", [2, 4])
def test_encode_pipe2_dense_matches_jax(M):
    """:113: the dense route (MHA blocks, post-LN) on pipe 2, the JAX
    ``encode`` on a (data 1, pipe 2) mesh with 2 microbatches."""
    from tencent_recommendation_2025_tpu.models import encoder as JENC

    jcfg, cfg, jparams, pos, emb, ids, tt = _encode_pair(
        dict(hidden_units=32, num_blocks=2, num_heads=2, maxlen=20,
             dtype="float32", reference_init=False), B=4)
    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                 ("data", "pipe"))
    want = JENC.encode(jparams, jnp.asarray(emb), jnp.asarray(ids),
                       jnp.asarray(tt), jnp.asarray(pos), jcfg, train=False,
                       mesh=jmesh, pp_microbatches=2)
    got = _port_encode(cfg, jparams, pos, emb, ids, tt,
                       LocalMesh(pipe=2, pp_microbatches=M), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@requires_8
def test_encode_pipe2_fused_matches_jax(monkeypatch):
    """:137: the fused whole-block route inside each stage (the port's
    plain version of its kernels on the CPU; the JAX kernel in interpret
    mode, its gate patched open here, in this test only)."""
    from tencent_recommendation_2025_tpu.models import encoder as JENC
    from tencent_recommendation_2025_tpu.ops import fused_block as JFB

    jcfg, cfg, jparams, pos, emb, ids, tt = _encode_pair(
        dict(hidden_units=16, num_heads=2, num_blocks=2, maxlen=255,
             block_type="hstu", ffn_type="swiglu", hstu_rel_pos_buckets=128,
             dtype="float32", dropout_rate=0.0, reference_init=False), B=4)
    calls = []
    monkeypatch.setattr(JFB, "fused_block_supported",
                        lambda c, l, backend: calls.append(l) or True)
    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                 ("data", "pipe"))
    want = JENC.encode(jparams, jnp.asarray(emb), jnp.asarray(ids),
                       jnp.asarray(tt), jnp.asarray(pos), jcfg, train=False,
                       mesh=jmesh, pp_microbatches=2)
    assert calls
    got = _port_encode(cfg, jparams, pos, emb, ids, tt,
                       LocalMesh(pipe=2, pp_microbatches=2), "fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_encode_pipe_dropout_masks_differ_between_microbatches():
    """Two microbatches of identical rows draw different masks (the JAX
    package's ADVICE r4 fault: without the microbatch in the seed, row r
    of every microbatch drew one mask), on the fused and the dense routes;
    the same generator state draws the same output twice."""
    from tencent_recommendation_2025_tpu_torch.config import ModelConfig
    from tencent_recommendation_2025_tpu_torch.models import encoder as TENC

    cfg = ModelConfig(hidden_units=16, num_heads=1, num_blocks=2,
                      maxlen=127, block_type="hstu", ffn_type="swiglu",
                      dtype="float32", dropout_rate=0.3,
                      reference_init=False)
    params = TENC.init_encoder_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    L, D = cfg.maxlen + 1, cfg.hidden_units
    row = rng.standard_normal((1, L, D)).astype(np.float32)
    emb = torch.from_numpy(np.repeat(row, 4, axis=0))   # 4 identical rows
    ids = torch.ones((4, L), dtype=torch.int32)
    pos = torch.zeros((L + 1, D))
    for route in ("fused", "dense"):
        outs = []
        for _ in range(2):
            with torch.no_grad():
                outs.append(TENC.encode(
                    params, emb, ids, ids, pos, cfg, train=True,
                    gen=torch.Generator().manual_seed(11),
                    mesh=LocalMesh(pipe=2, pp_microbatches=4),
                    route=route))
        out = outs[0]
        # microbatches 0 and 1 of this shard: rows 0-1 and 2-3 (2 a
        # microbatch); rows 0 and 2 sit at the same index of each
        assert not torch.allclose(out[0], out[2]), route
        assert torch.equal(outs[0], outs[1]), route
