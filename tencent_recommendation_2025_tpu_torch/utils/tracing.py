"""Named spans and host counters of the port, for an operator's trace.

- :func:`span` opens a profiler range ``SPAN_PREFIX + name`` while a
  profiler runs (``cli.train --profile_steps``, ``utils.debug.
  profile_trace``, any ``torch.profiler.profile``), so that the trace shows
  which step of the program launched each kernel: on the trace's own clock,
  nested as the calls nest, each kernel linked to the op (or, for a kernel
  of ``csrc/`` launched outside any op, the span) that launched it. With
  no profiler running it is one flag read and a shared null context: the
  serving scan opens two spans a corpus block. ``scripts/trace_spans.py``
  sums a trace's device time and idle gaps by span.

  A span is a range of the ops' own scope, not a user annotation
  (``record_function``): the profiler ties each kernel to the innermost
  user annotation around its launch and builds an annotation's
  device-lane copy from those kernels alone, so a user annotation inside
  the port would empty the device-lane copy of an operator's own
  ``record_function`` around a call into it. The span's ``args`` show in
  the trace where the profiler records shapes (``record_shapes=True``).
- :func:`count` adds a host integer to a named counter, from any thread (the
  host preps run on the loader's worker threads). A counter only adds
  values the host already holds: none syncs the device.
- :func:`counters` is a snapshot of them. ``train.trainer._stop_profiler``
  writes their change over the traced steps into the trace.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

#: the prefix of every span's name in a trace
SPAN_PREFIX = "rec."

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = collections.Counter()


def span(name: str, args: Optional[Dict[str, int]] = None):
    """A profiler range ``rec.<name>`` (``args``: values the trace shows
    beside it) while a profiler runs, else a shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if args:
        return _RecordFunctionFast(SPAN_PREFIX + name, (), args)
    return _RecordFunctionFast(SPAN_PREFIX + name)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host integer) to counter ``name``."""
    with _lock:
        _counts[name] += int(n)


def counters() -> Dict[str, int]:
    """The counters' values now."""
    with _lock:
        return dict(_counts)
