"""The whole step's share of the cards' bf16 peak: the analytic step
operations (a frozen copy of ``analytic_step_flops``) times the window's
steps, over its seconds and 989e12 times the cards, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.train_mfu(run)
