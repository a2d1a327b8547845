"""Arithmetic the metric files share. Each file under ``end_to_end/`` and
``metrics/`` is the reader of one metric and calls one of these; a reader
that finds nothing to read returns None and the metric stays out of the
line."""

from __future__ import annotations

from typing import Optional

from . import bounds as BD
from . import record as R

#: the fused HSTU block's kernels (csrc/fused_block.cu, fused_block_bwd.cu,
#: the attention backward of csrc/hstu_attn_bwd_sm90.cuh and the weight
#: partials' reduces), their wgmma designs and their first ones
FUSED_BLOCK_KERNELS = (
    "proj_wgmma_kernel", "attn_ffn_wgmma_kernel", "proj_kernel",
    "attn_ffn_kernel", "proj_bwd_wgmma_kernel", "gate_ffn_bwd_wgmma_kernel",
    "wgrad_wgmma_kernel", "gate_ffn_bwd_kernel", "proj_bwd_kernel",
    "attn_bwd_dq_wgmma_kernel", "attn_bwd_dkdv_wgmma_kernel",
    "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel", "reduce_rows_kernel",
    "reduce_rows_split_kernel")


def per_s(run: R.Run) -> Optional[float]:
    """Rows completed a second over the window (examples or queries)."""
    if run.window_s <= 0 or run.units == 0:
        return None
    return run.units * run.rows / run.window_s


def host_prep_ms(run: R.Run, names) -> Optional[float]:
    """Host ms a step in the program's host preps named, each over its own
    calls in the window."""
    got = [run.host_s[n] / run.counts[n] * 1e3 for n in names
           if run.counts.get(n)]
    return sum(got) if got else None


def idle_share(run: R.Run) -> Optional[float]:
    return R.traced(
        run, lambda t: 100.0 * (1.0 - t.busy_s / t.traced_s)
        if t.traced_s > 0 else None)


def collective_share(run: R.Run) -> Optional[float]:
    """The collectives' share of the card's busy time in the profiled
    stretch (the mean over the cards of each), in %; nothing to read where
    no collective ran."""
    return R.traced(
        run, lambda t: 100.0 * t.collective_s / t.busy_s
        if t.collective_s > 0 and t.busy_s > 0 else None)


def _untraced_rate(run: R.Run) -> Optional[float]:
    """Steps or requests a second over the window without its profiled
    stretch (the profiler slows the host, and its reduction takes time)."""
    n = run.units - run.traced_units
    s = run.window_s - run.traced_wall_s
    return n / s if n > 0 and s > 0 else None


def train_mfu(run: R.Run) -> Optional[float]:
    """The window's analytic step operations a second over the bf16 peak
    of its cards, in %."""
    rate = _untraced_rate(run)
    if run.trace is None or rate is None:
        return None
    f = BD.step_flops(run.config, run.rows, run.dedup)
    return 100.0 * f * rate / (BD.PEAK_BF16_FLOPS * run.chips)


def serve_mfu(run: R.Run) -> Optional[float]:
    """The window's predict and scan operations a second over the bf16
    peak, in %."""
    rate = _untraced_rate(run)
    if run.trace is None or rate is None:
        return None
    D = run.config["model"]["hidden_units"]
    f = BD.predict_flops(run.config, run.rows) \
        + 2.0 * run.rows * run.traffic["corpus_rows"] * D
    return 100.0 * f * rate / BD.PEAK_BF16_FLOPS


def _shape(run: R.Run):
    m = run.config["model"]
    D = m["hidden_units"]
    return (run.rows // run.chips, m["maxlen"] + 1, D, m["num_heads"],
            BD.swiglu_hidden(D, m["ffn_hidden_mult"], m["ffn_multiple_of"]),
            m["num_blocks"], m["hstu_rel_pos_buckets"])


def fused_block_roofline(run: R.Run) -> Optional[float]:
    """The fused blocks' least time (forward and backward bounds of each
    block launch) over the device time of the fused kernels, in %."""
    B, L, D, H, F, NB, buckets = _shape(run)
    per_step = NB * (BD.bound_s(*BD.fused_block_fwd(B, L, D, H, F, 2, True,
                                                    buckets))
                     + BD.bound_s(*BD.fused_block_bwd(B, L, D, H, F, 2,
                                                      buckets)))

    def share(t):
        ms = R.kernel_ms(t, FUSED_BLOCK_KERNELS)
        return 100.0 * per_step * t.units / (ms / 1e3) if ms > 0 else None

    return R.traced(run, share)


def mips_roofline(run: R.Run) -> Optional[float]:
    """Exact top-k's least time (the f32 corpus read once, or its scoring
    operations) over the device time under the top-k span, in %."""
    N = run.traffic["corpus_rows"]
    D = run.config["model"]["hidden_units"]
    least = BD.mips_bound_s(run.rows, N, D)

    def share(t):
        ms = t.spans_ms.get("pb.mips", 0.0)
        return 100.0 * least * t.units / (ms / 1e3) if ms > 0 else None

    return R.traced(run, share)


def span_ms(run: R.Run, span: str) -> Optional[float]:
    """Device ms a step or request under benchmark span ``span``."""
    return R.traced(
        run, lambda t: t.spans_ms[span] / t.units
        if t.spans_ms.get(span) and t.units else None)


def sparse_table_roofline(run: R.Run) -> Optional[float]:
    """The row-sparse table update's least time (each touched row read and
    written once in the table's f32, its accumulator read and written)
    over the device time under the table's gather and update spans, in %."""
    if not run.counts.get("touched_rows") or not run.counts.get(
            "prep.sparse"):
        return None
    D = run.config["model"]["hidden_units"]
    rows = run.counts["touched_rows"] / run.counts["prep.sparse"]
    least = BD.bound_s(0.0, rows * (2 * D * 4 + 2 * 4))

    def share(t):
        ms = t.spans_ms.get("pb.table_gather", 0.0) \
            + t.spans_ms.get("pb.table_update", 0.0)
        return 100.0 * least * t.units / (ms / 1e3) if ms > 0 else None

    return R.traced(run, share)

