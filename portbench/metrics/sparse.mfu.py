"""The sparse step's share of the cards' bf16 peak, as ``train.mfu``."""

from portbench.bench import readers as RD


def read(run):
    return RD.train_mfu(run)
