"""Host ms a step in ``train/trainer.py``'s host preps of the flagship:
``augment_batch_dedup`` and ``put_batch`` (the prefetch thread), each
over its calls in the window."""

from portbench.bench import readers as RD


def read(run):
    return RD.host_prep_ms(run, ("prep.dedup", "put"))
