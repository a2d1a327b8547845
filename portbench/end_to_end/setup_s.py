"""Seconds from the start of the run's first process to the start of its
window: building and loading the kernels, making the weights, tables and
batches, and the checked first steps or warm-up requests."""

def read(run):
    return run.setup_s if run.setup_s > 0 else None
