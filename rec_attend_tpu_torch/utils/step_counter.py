"""A step counter that threads share.

Counterpart of ``rec_attend_tpu/utils/step_counter.py``.
"""

from __future__ import annotations

import threading


class StepCounter:

  def __init__(self, step=0):
    self._step = step
    self._lock = threading.Lock()

  def get(self):
    with self._lock:
      return self._step

  def increment(self, amount=1):
    with self._lock:
      self._step += amount
      return self._step

  def reset(self, step=0):
    with self._lock:
      self._step = step
