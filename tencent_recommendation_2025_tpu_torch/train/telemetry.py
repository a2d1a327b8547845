"""Metrics / logging / observability (C12 + SURVEY.md §5).

Keeps the reference's machine-readable contracts:
- JSONL ``train.log`` with per-step ``global_step/epoch/step/loss/step_time/
  elapsed_time/steps_per_second/estimated_remaining_time/time``
  (reference ``main.py:202-214``);
- TensorBoard scalars ``Loss/train``, ``Loss/valid``,
  ``Performance/{step_time,steps_per_second,validation_time}``
  (``main.py:224-226,264-265``) plus O1's ``Gradient/{mean,max}`` and
  ``LearningRate/*`` (``BaseLineO1/main.py:296-314``);

and adds the device-side metrics the north star asks for:
``Performance/examples_per_second_per_chip``, ``Performance/lookup_gb_s``
and ``Performance/mfu`` (the step's analytic matmul and attention FLOPs,
``trainer.analytic_step_flops``, over its time and the cards' bf16 peak,
``trainer.device_peak_flops``: written where that peak is known, an H100
training in bf16, never on the CPU), and ``Tables/ep_overflow`` on a
data-only mesh (the item ids past their all-to-all bucket in the step,
which returned zero rows and dropped their gradient; a warning line when
it is > 0).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class JsonlLogger:
    def __init__(self, log_dir: Optional[str]):
        self._f = None
        if log_dir:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._f = open(Path(log_dir) / "train.log", "w")

    def write(self, record: dict):
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


class TBWriter:
    """TensorBoard writer; no-op when tensorboard isn't importable."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                Path(log_dir).mkdir(parents=True, exist_ok=True)
                self._w = SummaryWriter(log_dir)
            except Exception:
                self._w = None

    def scalar(self, tag: str, value: float, step: int):
        if self._w:
            self._w.add_scalar(tag, value, step)

    def close(self):
        if self._w:
            self._w.close()


class StepTimer:
    """Wall-clock step telemetry (reference main.py:192-226 semantics).

    ``initial_step`` seeds ``global_step`` on resume so checkpoint names and
    TB x-axes stay monotone across restarts (the reference resumes epoch
    numbering from the filename, ``main.py:118-127``); steps/s and ETA are
    computed from THIS run's ticks only, not the restored offset.
    """

    def __init__(self, total_steps: int, initial_step: int = 0):
        self.total_steps = total_steps
        self.start = time.time()
        self.global_step = initial_step
        self._ticks = 0

    def tick(self, step_time: float) -> dict:
        self.global_step += 1
        self._ticks += 1
        elapsed = time.time() - self.start
        sps = self._ticks / elapsed if elapsed > 0 else 0.0
        remaining = (self.total_steps - self.global_step) / sps if sps > 0 else 0.0
        return {
            "step_time": step_time,
            "elapsed_time": elapsed,
            "steps_per_second": sps,
            "estimated_remaining_time": remaining,
            "time": time.time(),
        }


def format_time(seconds: float) -> str:
    """h/m/s pretty-printer (reference utils.py ``format_time``)."""
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h {m}m {s}s"
    if m:
        return f"{m}m {s}s"
    return f"{s}s"
