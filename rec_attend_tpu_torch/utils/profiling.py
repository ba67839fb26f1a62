"""A profiler trace around a window of steps, and a step timer.

Counterpart of ``rec_attend_tpu/utils/profiling.py``: ``trace(logdir)``
records ``torch.profiler``'s host activity and, where the card is there,
its kernels (CUPTI), and writes a Chrome trace (``chrome://tracing`` or
Perfetto open it) into ``logdir`` when the window closes;
``StepTimer`` is the JAX package's.

    with profiling.trace('logs/<id>/trace'):
      trainer.train_step(batch)
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

TRACE_NAME = 'trace.json'


@contextlib.contextmanager
def trace(logdir: str):
  """Profile the block; its Chrome trace goes to ``logdir``/trace.json
  (``TRACE_NAME``), replacing an earlier one."""
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(logdir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield
    if torch.cuda.is_available():
      torch.cuda.synchronize()
  prof.export_chrome_trace(os.path.join(logdir, TRACE_NAME))


class StepTimer:
  """Wall-clock step timing with summary percentiles."""

  def __init__(self):
    self.times_ms = []
    self._t0 = None

  def start(self):
    self._t0 = time.perf_counter()

  def stop(self):
    if self._t0 is not None:
      self.times_ms.append((time.perf_counter() - self._t0) * 1000)
      self._t0 = None

  def summary(self):
    if not self.times_ms:
      return {}
    a = np.array(self.times_ms)
    return {'mean_ms': float(a.mean()), 'p50_ms': float(np.percentile(a, 50)),
            'p90_ms': float(np.percentile(a, 90)),
            'p99_ms': float(np.percentile(a, 99)), 'n': len(a)}
