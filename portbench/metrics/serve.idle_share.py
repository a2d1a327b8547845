"""The card's idle share of the profiled requests, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.idle_share(run)
