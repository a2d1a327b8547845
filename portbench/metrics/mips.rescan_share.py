"""Rows of the exact top-k scanned a second time for a tie at the k-th
place (``retrieval/mips.py`` ``_resolve_spills``), % of the queries
scanned: the program's counters ``mips.rescanned_rows`` over
``mips.queries``. ``_resolve_spills`` counts on every call, 0 included, so
a program that lost the count reads None, never 0. The counters run from
the process's start (``record.profile_stretch`` takes no snapshot of
them), so they hold every request of the run, warm-up included; the
harness reads per-layer metrics on its traced run only. Nothing to read
where the program has no counters."""


def read(run):
    try:
        from tencent_recommendation_2025_tpu_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if "mips.rescanned_rows" not in c or not c.get("mips.queries"):
        return None
    return 100.0 * c["mips.rescanned_rows"] / c["mips.queries"]
