"""The package's logger.

Counterpart of ``rec_attend_tpu/utils/logger.py:30-91``: one ``Logger``
for the process (``get``), lines of ``LEVEL date file:line message`` on
standard error and, where a file was given, appended to it; a ``VERBOSE``
environment threshold for the calls that pass ``verbose``; ``fatal``
exits.  Built on the standard ``logging`` module.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

_lock = threading.Lock()
_default_logger = None
_FORMAT = logging.Formatter(
    '%(levelname)-5.5s %(asctime)s %(filename)s:%(lineno)d %(message)s',
    datefmt='%Y-%m-%d %H:%M:%S')


class Logger:

  def __init__(self, filename: str | None = None, default_verbose: int = 0):
    self.filename = filename
    try:
      self.verbose_thresh = int(os.environ.get('VERBOSE', default_verbose))
    except ValueError:
      self.verbose_thresh = default_verbose
    self._log = logging.getLogger(f'rec_attend_tpu_torch.{id(self)}')
    self._log.setLevel(logging.DEBUG)
    self._log.propagate = False
    handlers = [logging.StreamHandler(sys.stderr)]
    if filename is not None:
      os.makedirs(os.path.dirname(filename) or '.', exist_ok=True)
      handlers.append(logging.FileHandler(filename))
    for h in handlers:
      h.setFormatter(_FORMAT)
      self._log.addHandler(h)

  def log(self, message, typ='info', verbose=0):
    if verbose > self.verbose_thresh:
      return
    level = {'fatal': logging.CRITICAL}.get(typ) or getattr(
        logging, typ.upper())
    # The record names the first caller outside this module.
    depth, frame = 2, sys._getframe(1)
    while frame is not None and frame.f_code.co_filename == __file__:
      depth, frame = depth + 1, frame.f_back
    self._log.log(level, message, stacklevel=depth)

  def debug(self, m, verbose=2):
    self.log(m, 'debug', verbose)

  def info(self, m, verbose=0):
    self.log(m, 'info', verbose)

  def warning(self, m, verbose=0):
    self.log(m, 'warning', verbose)

  def error(self, m, verbose=0):
    self.log(m, 'error', verbose)

  def fatal(self, m):
    self.log(m, 'fatal')
    sys.exit(1)

  def log_args(self):
    self.info('Command: {}'.format(' '.join(sys.argv)))


def get(filename: str | None = None) -> Logger:
  """The process's logger (the first call that names a file attaches it)."""
  global _default_logger
  with _lock:
    if _default_logger is None or (filename is not None
                                   and _default_logger.filename is None):
      _default_logger = Logger(filename)
  return _default_logger
