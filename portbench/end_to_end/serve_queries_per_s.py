"""Queries answered a second: every query of the window's requests (top-10
ids on the host) over the window's seconds."""

from portbench.bench import readers as RD


def read(run):
    return RD.per_s(run) if run.kind == "serve" else None
