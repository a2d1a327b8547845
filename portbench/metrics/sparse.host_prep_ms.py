"""Host ms a step in ``train/trainer.py``'s host preps of the sparse step:
``augment_batch_dedup`` (one card), ``augment_batch_sparse`` and
``put_batch``, each over its calls in the window."""

from portbench.bench import readers as RD


def read(run):
    return RD.host_prep_ms(run, ("prep.dedup", "prep.sparse", "put"))
