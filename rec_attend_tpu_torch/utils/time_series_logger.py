"""Buffered CSV time series of a training run.

Counterpart of ``rec_attend_tpu/utils/time_series_logger.py:15-64``: a CSV
file ``step,time,<label...>`` a row per ``add``, written every
``buffer_size`` rows and on ``flush``; on a restore the rows after the
restored step are dropped, so that the series stays in step order.
"""

from __future__ import annotations

import datetime
import os


class TimeSeriesLogger:

  def __init__(self, filename, labels, name=None, buffer_size=20,
               restore_step=0):
    self.filename = filename
    if isinstance(labels, str):
      labels = [labels]
    self.labels = labels
    self.name = name or labels[0]
    self.buffer_size = buffer_size
    self._buffer = []
    os.makedirs(os.path.dirname(filename) or '.', exist_ok=True)
    if restore_step > 0 and os.path.exists(filename):
      self._truncate(restore_step)
    if not os.path.exists(filename):
      self._buffer.append('step,time,' + ','.join(self.labels) + '\n')
      self.flush()

  def _truncate(self, restore_step):
    with open(self.filename) as f:
      lines = f.readlines()
    kept = [lines[0]] if lines else []
    for line in lines[1:]:
      try:
        step = int(line.split(',', 1)[0])
      except ValueError:
        continue
      if step <= restore_step:
        kept.append(line)
    with open(self.filename, 'w') as f:
      f.writelines(kept)

  def add(self, step, values):
    if not isinstance(values, (list, tuple)):
      values = [values]
    t = datetime.datetime.now(datetime.timezone.utc).isoformat()
    row = f'{step},{t},' + ','.join('' if v is None else str(v)
                                    for v in values) + '\n'
    self._buffer.append(row)
    if len(self._buffer) >= self.buffer_size:
      self.flush()

  def flush(self):
    if self._buffer:
      with open(self.filename, 'a') as f:
        f.writelines(self._buffer)
      self._buffer = []

  def close(self):
    self.flush()
