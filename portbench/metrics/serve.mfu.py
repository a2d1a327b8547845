"""A request's share of the card's bf16 peak: predict's analytic
operations and the exact scan's 2QND, times the window's requests, over
its seconds and 989e12, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.serve_mfu(run)
