"""Restart a training run from its newest checkpoint when it fails.

Counterpart of ``tencent_recommendation_2025_tpu/train/supervisor.py``. The
reference recovers only by hand (``--state_dict_path``, ``main.py:120-128``);
here a supervisor wraps the training function and, on any exception,
restarts it from the newest complete checkpoint, at most ``max_restarts``
times. Checkpoints are staged and renamed (``train/checkpoint.py``), so a
kill mid-write never leaves a half checkpoint to restart from.
:class:`FaultInjected` is the exception tests raise to stand for a host
failure.
"""

from __future__ import annotations

import inspect
import time
import traceback
from typing import Callable

from . import checkpoint as CK


class FaultInjected(RuntimeError):
    pass


def run_supervised(train_fn: Callable[..., object], ckpt_dir, model, cfg,
                   max_restarts: int = 3, backoff_s: float = 0.0,
                   verbose: bool = True, device="cuda"):
    """Run ``train_fn(resume_state_or_None, attempt)``, restarting it on a
    crash.

    ``train_fn`` checkpoints into ``ckpt_dir`` as it goes and returns the
    final state. On an exception the supervisor loads the newest checkpoint
    with ``checkpoint.load_checkpoint(path, model, cfg, device)`` and calls
    ``train_fn`` again, after ``backoff_s`` seconds; the exception of the
    attempt after ``max_restarts`` restarts is raised. The port's
    checkpoint loader builds the state from ``model`` and ``cfg``, so they
    stand where the JAX function takes a state template.

    A ``train_fn`` with a third parameter also receives the restored
    checkpoint's meta (None on the first attempt and where no checkpoint
    exists): pass ``meta["epoch"]`` to ``train_loop(start_epoch=...)`` so a
    restart trains only the epochs left, and ``meta.get("epoch_step", 0)``
    to ``skip_steps=`` so a preemption checkpoint resumes mid-epoch."""
    wants_meta = len(inspect.signature(train_fn).parameters) >= 3
    attempt = 0
    resume, meta = None, None
    while True:
        try:
            if wants_meta:
                return train_fn(resume, attempt, meta)
            return train_fn(resume, attempt)
        except Exception as e:  # noqa: BLE001 — the supervisor takes all
            attempt += 1
            if attempt > max_restarts:
                raise
            if verbose:
                print(f"supervisor: attempt {attempt} failed with "
                      f"{type(e).__name__}: {e}; restarting from latest "
                      "checkpoint")
                traceback.print_exc(limit=1)
            latest = CK.latest_checkpoint(ckpt_dir)
            resume, meta = None, None
            if latest is not None:
                resume, meta = CK.load_checkpoint(latest, model, cfg,
                                                  device=device)
                if verbose:
                    print(f"supervisor: restored {latest.name} "
                          f"(step {meta.get('global_step')}, "
                          f"epoch {meta.get('epoch')})")
            if backoff_s:
                time.sleep(backoff_s)
