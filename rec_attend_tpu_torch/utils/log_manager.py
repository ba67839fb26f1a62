"""The catalog of a run's log files.

Counterpart of ``rec_attend_tpu/utils/log_manager.py:15-34``: a
``catalog`` file in the logs folder, ``filename,type,name`` a line, each
file registered once, for the dashboard that reads the folder.
"""

from __future__ import annotations

import os
import threading


class LogManager:

  def __init__(self, folder):
    self.folder = folder
    self._lock = threading.Lock()
    self._registered = {}
    os.makedirs(folder, exist_ok=True)
    self.catalog = os.path.join(folder, 'catalog')
    with open(self.catalog, 'w') as f:
      f.write('filename,type,name\n')

  def register(self, filename, typ, name):
    base = os.path.basename(filename)
    with self._lock:
      if base in self._registered:
        return
      self._registered[base] = (typ, name)
      with open(self.catalog, 'a') as f:
        f.write(f'{base},{typ},{name}\n')
