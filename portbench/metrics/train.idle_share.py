"""The card's idle share of the profiled stretch early in the window: 1 -
the union of its operations' intervals over the stretch's seconds, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.idle_share(run)
