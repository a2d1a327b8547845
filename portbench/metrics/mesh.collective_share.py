"""``parallel/mesh.py``, ``parallel/sharded_embedding.py``: the NCCL
kernels' share of the card's busy time in the profiled steps (the sharded
lookup's exchanges, the table rows' and the dense gradients' all-reduce),
the mean over the cards, in %."""

from portbench.bench import readers as RD


def read(run):
    return RD.collective_share(run)
