"""Training examples completed a second with the 100M-row row-sparse item
table: every example of the window's steps (the global batch on several
cards) over the window's seconds."""

from portbench.bench import readers as RD


def read(run):
    return RD.per_s(run) if run.kind == "train" else None
