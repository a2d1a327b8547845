"""Tensor parallelism on local meshes, the steps of tests/test_torch_tp.py's
cases other than the flagship's (the same checks, in a file of their own
so that each file's JAX compiles stay short): ``sharded_multihost`` cut to
2 blocks, D=32, H=4 with sparse ``item_emb`` and the stacked tower dedup
on data 4 x model 2 (tests/test_tower_dedup.py:335) and ``baseline`` on
model 2, against the single device's port step and the JAX package's mesh
step; ``baseline`` on model 4 against the single device's."""

import jax
import pytest

import test_torch_tp as TT

world = TT.world

CASES = ("sharded_multihost_d4m2", "baseline_m2", "baseline_m4")
assert set(CASES) | set(TT.HERE) == set(TT.CASES)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 fake devices")
@pytest.mark.parametrize("case", CASES)
def test_model_mesh_step_matches_one_device_and_jax_mesh(world, case):
    TT.check_model_mesh_step(world, case)
