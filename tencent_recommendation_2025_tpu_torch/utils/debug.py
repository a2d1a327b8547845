"""Debug switches: fail fast at a NaN, flag the ops that are not
deterministic, trace a scope.

Counterpart of ``tencent_recommendation_2025_tpu/utils/debug.py``, with its
names, each mapped onto the nearest PyTorch switch:

- :func:`enable_nan_checks` — autograd's anomaly mode with its NaN check
  (``torch.autograd.set_detect_anomaly(on, check_nan=True)``): a backward
  that produces a NaN raises, naming the forward op that made it (JAX:
  ``jax_debug_nans``);
- :func:`enable_checks` — ``torch.use_deterministic_algorithms(on,
  warn_only=True)``: every op without a deterministic implementation on its
  device (CUDA atomics, whose order varies from run to run) warns with its
  name, and ops that have one take it (JAX: ``jax_enable_checks``, the
  internal invariant checks);
- :func:`debug_mode` — both, for a scope, restoring the previous switches;
- :func:`profile_trace` — a ``torch.profiler`` trace of a scope, written as
  ``log_dir/trace.json`` as the train loop's ``--profile_steps`` writes it
  (JAX: ``jax.profiler``).

The step's randomness is already a function of the seed and the step
(``train.trainer.step_generator``), so a run replays with the same seed.
"""

from __future__ import annotations

import contextlib

import torch


def enable_nan_checks(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on, check_nan=on)


def enable_checks(on: bool = True) -> None:
    torch.use_deterministic_algorithms(on, warn_only=on)


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = False):
    """Scoped NaN and determinism checking for reproducing failures."""
    prev_anomaly = torch.is_anomaly_enabled()
    prev_nan = torch.is_anomaly_check_nan_enabled()
    prev_det = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    try:
        enable_nan_checks(nans)
        enable_checks(checks)
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev_anomaly, check_nan=prev_nan)
        torch.use_deterministic_algorithms(prev_det, warn_only=prev_warn)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the scope (the card's kernels too where
    there is one), written to ``log_dir/trace.json``."""
    from ..train.trainer import _start_profiler, _stop_profiler

    prof = _start_profiler()
    try:
        yield
    finally:
        _stop_profiler(prof, log_dir, verbose=False)
