"""The card's idle share of the profiled steps, in % (on several cards the
mean over them)."""

from portbench.bench import readers as RD


def read(run):
    return RD.idle_share(run)
