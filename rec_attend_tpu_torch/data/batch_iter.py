"""Batch index iterators with host-side prefetch.

Counterpart of ``rec_attend_tpu/data/batch_iter.py:19-199``: a thread-safe
index iterator with cycle/shuffle (seed 2)/non-cycling modes, epoch
tracking and wrap-around batches, and a concurrent wrapper running
``get_fn`` in producer threads feeding a bounded queue.  The producers
make host numpy batches only: no CUDA call runs in them, the upload stays
with the consumer (``engine.experiment.TrainingExperiment``).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class BatchIterator:

  def __init__(self, num, batch_size=1, progress_bar=False, get_fn=None,
               cycle=False, shuffle=True, stagnant=False, seed=2,
               num_batches=-1):
    self._num = num
    self._batch_size = batch_size
    self._get_fn = get_fn
    self._cycle = cycle
    self._shuffle = shuffle
    self._stagnant = stagnant
    self._random = np.random.RandomState(seed)
    if shuffle:
      self._shuffle_idx = self._random.permutation(num)
    else:
      self._shuffle_idx = np.arange(num)
    self._step = 0
    self._epoch = 0
    self._pos = 0
    self._lock = threading.Lock()
    self._max_steps = num_batches

  def __iter__(self):
    return self

  def get_fn(self, idx):
    if self._get_fn is not None:
      return self._get_fn(idx)
    return idx

  def reset(self):
    with self._lock:
      self._pos = 0
      self._epoch = 0
      self._step = 0

  @property
  def epoch(self):
    return self._epoch

  def __next__(self):
    with self._lock:
      if self._max_steps >= 0 and self._step >= self._max_steps:
        raise StopIteration
      if self._pos >= self._num:
        if not self._cycle:
          raise StopIteration
        self._pos = 0
        self._epoch += 1
        if self._shuffle:
          self._shuffle_idx = self._random.permutation(self._num)
      start = self._pos
      end = min(start + self._batch_size, self._num)
      idx = self._shuffle_idx[start:end]
      if self._cycle and end - start < self._batch_size:
        # Wrap-around batch: fill from the start of the next epoch.
        self._epoch += 1
        if self._shuffle:
          self._shuffle_idx = self._random.permutation(self._num)
        rem = self._batch_size - (end - start)
        idx = np.concatenate([idx, self._shuffle_idx[:rem]])
        self._pos = rem
      else:
        if not self._stagnant:
          self._pos = end
      self._step += 1
    return self.get_fn(idx)

  next = __next__


class ConcurrentBatchIterator:
  """Prefetching wrapper: N producer threads call the underlying iterator
  and push results into a bounded queue; a None sentinel marks the end of
  non-cycling data.

  Dead producers (a crashed ``get_fn``) are detected and relaunched like
  the reference's scan loop (utils/concurrent_batch_iter.py:110-133), so a
  transient worker failure cannot silently end an epoch early or deadlock
  the consumer.  ``MAX_RELAUNCH`` bounds pathological crash loops.
  """

  MAX_RELAUNCH = 100

  def __init__(self, batch_iter, max_queue_size=10, num_threads=4,
               log_queue=-1):
    self._iter = batch_iter
    self._q = queue.Queue(maxsize=max_queue_size)
    self._threads = []
    self._stopped = threading.Event()
    self._exhausted = threading.Event()
    self._num_threads = num_threads
    self._clean_exits = set()
    self._scan_lock = threading.Lock()
    self._relaunches = 0
    self._start_threads()

  def _spawn(self):
    t = threading.Thread(target=self._producer, daemon=True)
    t.start()
    return t

  def _start_threads(self):
    self._threads = [self._spawn() for _ in range(self._num_threads)]

  def _producer(self):
    # Clean exits are tracked by Thread object, not ident — the OS
    # recycles idents, which could make a crashed relaunch look clean.
    me = threading.current_thread()
    try:
      while not self._stopped.is_set():
        try:
          batch = next(self._iter)
        except StopIteration:
          self._clean_exits.add(me)
          self._exhausted.set()
          self._q.put(None)
          return
        self._q.put(batch)
      self._clean_exits.add(me)
    except Exception as e:   # noqa: BLE001 — scan() relaunches the worker
      from rec_attend_tpu_torch.utils import logger
      logger.get().error(f'Batch producer thread died: {e!r}')

  def scan(self):
    """Relaunch producers that died without a clean exit
    (ref concurrent_batch_iter.py:110-133)."""
    with self._scan_lock:
      if self._stopped.is_set():
        return
      for i, t in enumerate(self._threads):
        if not t.is_alive() and t not in self._clean_exits:
          if self._relaunches >= self.MAX_RELAUNCH:
            raise RuntimeError(
                f'Batch producer crashed > {self.MAX_RELAUNCH} times; '
                'giving up (inspect the data pipeline).')
          self._relaunches += 1
          from rec_attend_tpu_torch.utils import logger
          logger.get().warning('Relaunching dead batch producer thread')
          self._threads[i] = self._spawn()

  def __iter__(self):
    return self

  def __next__(self):
    while True:
      try:
        batch = self._q.get(timeout=0.2)
      except queue.Empty:
        # Nothing produced in a while: recover any crashed workers, and
        # stop only once every producer has exited (a bare "exhausted"
        # flag would drop batches still in flight in other producers).
        self.scan()
        if (self._exhausted.is_set() and self._q.empty()
            and not any(t.is_alive() for t in self._threads)):
          raise StopIteration
        continue
      if batch is None:
        continue
      return batch

  next = __next__

  def reset(self):
    self.stop()
    self._iter.reset()
    self._stopped = threading.Event()
    self._exhausted = threading.Event()
    self._q = queue.Queue(maxsize=self._q.maxsize)
    self._clean_exits = set()
    self._relaunches = 0
    self._start_threads()

  def stop(self):
    self._stopped.set()
    # Drain so producers blocked on put() can exit.
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass
