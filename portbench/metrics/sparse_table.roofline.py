"""``ops/sparse_table.py`` -> ``csrc/sparse_table.cu``: the touched rows read
and written back once (f32 rows and their Adagrad accumulators) over the
device time under the table's gather and update calls, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.sparse_table_roofline(run)
