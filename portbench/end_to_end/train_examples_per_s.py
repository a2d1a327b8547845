"""Training examples completed a second: every example of the window's
steps over the window's seconds (host clock, the card drained at both
ends)."""

from portbench.bench import readers as RD


def read(run):
    return RD.per_s(run) if run.kind == "train" else None
