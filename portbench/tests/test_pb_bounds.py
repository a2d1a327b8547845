"""The yardstick's arithmetic against the hand counts of PERF.md section 6
(rows 1-2, B=128, L=1024, D=64, H=1, SwiGLU 256, bf16) and the frozen step
count against the program's own."""

import pytest

import tiny  # noqa: F401
from portbench.bench import bounds as BD


def test_fused_block_forward():
    flops, nbytes = BD.fused_block_fwd(128, 1024, 64, 1, 256, 2, train=False)
    assert flops / 1e9 == pytest.approx(35.45, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(34.22, abs=0.005)
    assert BD.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0358, abs=5e-5)


def test_fused_block_backward():
    flops, nbytes = BD.fused_block_bwd(128, 1024, 64, 1, 256, 2)
    assert flops / 1e9 == pytest.approx(93.46, abs=0.005)
    assert nbytes / 1e6 == pytest.approx(68.06, abs=0.005)
    assert BD.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0945, abs=5e-5)


def test_mips_bound_reads_the_corpus_once():
    assert BD.mips_bound_s(128, 10_000_000, 64) == pytest.approx(
        4 * 10_000_000 * 64 / 3.35e12)


@pytest.mark.parametrize("workload,chips", [
    ("flagship.train", 1), ("sparse100m.train", 1), ("sparse100m.train", 4)])
def test_step_flops_frozen_copy(workload, chips):
    """The frozen count equals the program's at the global batch of the
    cell's traffic on ``chips`` cards; on several processes the program
    trains without tower dedup."""
    from tencent_recommendation_2025_tpu_torch.train.trainer import \
        analytic_step_flops
    from portbench.bench import manifest
    from portbench.bench import program as PG
    from tiny import bench

    c = manifest.cell(workload, bench())
    B, dedup = c.traffic["rows_per_chip"] * chips, chips == 1
    cfg = PG.port_config(c.config, B)
    model = PG.port_model(c.config, cfg)
    assert BD.step_flops(c.config, B, dedup) == pytest.approx(
        analytic_step_flops(cfg, model, tower_dedup=dedup,
                            n_data_shards=chips))


def test_collective_share_reads_a_trace_with_collectives_only():
    from portbench.bench import readers as RD
    from portbench.bench import record as R

    run = R.Run(kind="train", chips=4, config={}, traffic={})
    assert RD.collective_share(run) is None
    run.trace = R.Trace(units=2, traced_s=1.0, busy_s=0.5, collective_s=0.2,
                        kernels_ms={}, spans_ms={}, idle_by_span_s={})
    assert RD.collective_share(run) == pytest.approx(40.0)
    run.trace.collective_s = 0.0
    assert RD.collective_share(run) is None
