"""Training runs and the eval of trained models.

Counterpart of ``rec_attend_tpu/engine/experiment.py``.
``TrainingExperiment`` (``:103-450``) is a training run as the command line
launches it: the model id and its results folder with the option
snapshots, the start from a pretrained model or the restore of the
folder's latest checkpoint (``finetune`` then restarts the step and the
optimizer), the train split fed from the host (prefetched by worker
threads where asked) or kept whole on the device as uint8
(``device_data``), the valid and trainval passes, the log CSVs, the
checkpoints and the stop at a non-finite loss, each on its cadence.  The
model of a spec ('full', 'box', 'fg') is its ``models.family`` entry.

``EvalExperiment`` is ``EvalExperiment`` (``:452-528``) with the ``full``
and ``fg`` specs: it restores a results folder's latest ``ckpt-*.npz``,
refuses a folder without one, and walks a dataset in index order,
unshuffled and without cycling, one eval forward a batch.

    exp = EvalExperiment('results/full_model_synth-20260816104712')
    for dataset, raw, outputs in exp.iterate_split(dataset, 8):
      outputs['y_out']    # [b, T, H, W] on the model's device
      outputs['s_out']    # [b, T]

    fg = EvalExperiment('results/fg_model_synth3-20260818a', spec='fg')
    for dataset, raw, outputs in fg.iterate_split(dataset, 8):
      outputs['y_out']    # [b, H, W, 1] foreground
      outputs['d_out']    # [b, H, W, 8] orientation

A dataset is any object with ``get_dataset_size()``,
``get_batch(idx, timespan)`` (a dict with 'x' [b,H,W,3], 's_gt' [b,T] and
'idx_map', the ids) and ``get_full_size_labels(ids, timespan)``;
``data.synthetic.SyntheticDataset`` is one.  A full model whose config reads
the fg model's packed predictions takes them from the batch's 'd_out'
[b,H,W,8] and 'y_out' [b,H,W,C] as its 'd_in' and 'y_in' (the spec's
``batch_map``); ``cli.pack.pack_fg`` gives a dataset that has them.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch import train_step as ts
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.data.batch_iter import BatchIterator
from rec_attend_tpu_torch.data.batch_iter import ConcurrentBatchIterator
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.engine.trainer import Trainer
from rec_attend_tpu_torch.models.family import family
from rec_attend_tpu_torch.models.family import get_model_spec
from rec_attend_tpu_torch.models.fg_model import fg_model_forward
from rec_attend_tpu_torch.models.full_model import full_model_forward
from rec_attend_tpu_torch.models.full_model import packed_inputs
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils.log_manager import LogManager
from rec_attend_tpu_torch.utils.time_series_logger import TimeSeriesLogger


def assign_model_id(prefix=''):
  """A model id stamped with the time, ``<prefix>-YYYYmmddHHMMSS``."""
  stamp = datetime.datetime.now().strftime('%Y%m%d%H%M%S')
  return f'{prefix}-{stamp}' if prefix else stamp


class TrainingExperiment:
  """A training run of the model of spec ``spec_name`` ('full', 'box' or
  'fg') on ``device`` (``cuda`` unless the caller asks for the CPU).

  ``train_cfg.restore`` names a results folder to go on from (its id and
  folder are the run's, its option snapshots stay as they are); else the
  run is ``train_cfg.results``/``model_id`` (a stamped id by default) and
  the snapshots are written.  ``seed`` seeds the initial parameters and
  the generator of every draw; a restored run starts its draws again from
  it, as the JAX run starts again from ``PRNGKey(seed)``.  ``plot_fn``
  (the experiment -> None) runs on the plot cadence.

      exp = TrainingExperiment('box', cvppp_box_config(), train_cfg,
                               data_cfg)
      exp.run()        # to train_cfg.num_steps; exp.trainer.model
  """

  def __init__(self, spec_name, model_cfg, train_cfg, data_cfg, seed=0,
               plot_fn=None, device=None):
    self.log = logger.get()
    self.spec = get_model_spec(spec_name)
    if family(model_cfg) is not self.spec:
      raise TypeError(f'spec {spec_name!r} does not take a '
                      f'{type(model_cfg).__name__}')
    self.model_cfg = model_cfg
    self.train_cfg = train_cfg
    self.data_cfg = data_cfg
    self.plot_fn = plot_fn

    # The model first: without a card this raises before anything is
    # written.
    self.trainer = Trainer(model_cfg, device=device, seed=seed)
    self.device = self.trainer.device
    restore = train_cfg.restore
    if restore:
      self.model_id = os.path.basename(restore.rstrip('/'))
      self.folder = restore
    else:
      self.model_id = (train_cfg.model_id
                       or assign_model_id(f'{spec_name}_model'))
      self.folder = os.path.join(train_cfg.results, self.model_id)
    # A restore keeps the snapshots written when the run began.
    self.saver = (saver.Saver(self.folder) if restore else
                  saver.Saver(self.folder, model_opt=model_cfg,
                              data_opt=data_cfg))
    self.variables = set(self.spec.batch_variables)
    if getattr(model_cfg, 'add_d_out', False):
      self.variables |= {'d_out', 'y_out'}

    self.load_pretrained()
    self.logs_folder = os.path.join(train_cfg.logs, self.model_id)
    self.log_manager = LogManager(self.logs_folder)
    self.loggers = {}
    self.log.info(f'Dashboard: http://{train_cfg.localhost}/deep-dashboard'
                  f'?id={self.model_id}')
    if restore and self.saver.get_latest_ckpt() is not None:
      self.restore_ckpt()
      if getattr(model_cfg, 'finetune', False):
        # Finetuning restarts the step and the optimizer, whose count sets
        # the learning rate's schedule.
        self.trainer.step = 0
        self.trainer.opt_state = ts.init_opt_state(self.trainer.model)

    self.train_ds = self.get_dataset('train')
    self.valid_ds = (self.get_dataset('valid') if train_cfg.has_valid
                     else None)
    timespan = getattr(model_cfg, 'timespan', None)
    device_data = bool(train_cfg.device_data)

    def make_iter(ds, prefetch):
      it = BatchIterator(ds.get_dataset_size(),
                         batch_size=train_cfg.batch_size, cycle=True,
                         shuffle=True,
                         get_fn=self.make_batch_fn(ds, timespan))
      if prefetch:
        it = ConcurrentBatchIterator(it, max_queue_size=train_cfg.queue_size,
                                     num_threads=train_cfg.num_worker)
      return it

    # With the split on the device the host iterator serves only the
    # trainval pass, one batch on its cadence: no prefetch for it.
    self.train_iter = make_iter(self.train_ds,
                                train_cfg.prefetch and not device_data)
    self.valid_iter = (make_iter(self.valid_ds, train_cfg.prefetch)
                       if self.valid_ds is not None else None)
    self.device_train_data = None
    # A run restored at its last step takes no step: no upload.
    if device_data and self.step < train_cfg.num_steps:
      self.device_train_data = self._load_device_split(self.train_ds,
                                                       timespan)
      self._idx_rng = np.random.RandomState(1234 + seed)
      self._perm = self._idx_rng.permutation(
          self.train_ds.get_dataset_size())
      self._ptr = 0

  @property
  def step(self):
    return self.trainer.step

  def make_batch_fn(self, dataset, timespan=None):
    """idx -> the host batch of those examples, under the batch keys (the
    spec's ``batch_map``): numpy only, so that worker threads may run it."""
    def get_batch(idx):
      raw = dataset.get_batch(idx, timespan=timespan,
                              variables=self.variables)
      return {dst: raw[src] for src, dst in self.spec.batch_map.items()
              if src in raw}
    return get_batch

  def get_dataset(self, split):
    h5 = {'train': self.train_cfg.h5_fname_train,
          'valid': self.train_cfg.h5_fname_valid}.get(split)
    return provider.get(self.data_cfg.dataset, self.data_cfg, split=split,
                        h5_fname=h5)

  def _load_device_split(self, ds, timespan, chunk=32):
    """The whole split, uint8 where ``encode_batch`` quantises, on the
    device: {batch key: tensor [N, ...]}."""
    n = ds.get_dataset_size()
    get = self.make_batch_fn(ds, timespan)
    chunks = [ts.encode_batch(get(np.arange(i, min(i + chunk, n))))
              for i in range(0, n, chunk)]
    data = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    mb = sum(v.nbytes for v in data.values()) / 1e6
    self.log.info(f'Device-resident train split: {n} examples, {mb:.0f} MB')
    return {k: torch.from_numpy(v).to(self.device) for k, v in data.items()}

  def _next_train_idx(self, bs):
    """Shuffled epochs over the device-resident split, as ``BatchIterator``
    cycles and shuffles (its own ``RandomState(1234 + seed)``)."""
    n = len(self._perm)
    if self._ptr + bs > n:
      tail = self._perm[self._ptr:]
      self._perm = self._idx_rng.permutation(n)
      self._ptr = bs - len(tail)
      return np.concatenate([tail, self._perm[:self._ptr]])
    out = self._perm[self._ptr:self._ptr + bs]
    self._ptr += bs
    return out

  def _logger_for(self, name, labels):
    if name not in self.loggers:
      fname = os.path.join(self.logs_folder, f'{name}.csv')
      self.loggers[name] = TimeSeriesLogger(fname, labels,
                                            restore_step=self.step)
      self.log_manager.register(fname, 'csv', name)
    return self.loggers[name]

  def _device_batch(self, batch):
    """A host batch, uint8 where ``encode_batch`` quantises, on the
    device."""
    return {k: torch.as_tensor(v).to(self.device)
            for k, v in ts.encode_batch(batch).items()}

  def _eval_pass(self, it, num_batches, split_name):
    """The eval step over ``num_batches`` batches of ``it``: the metrics'
    means weighted by the batch sizes, logged for ``split_name``."""
    sums = {}
    count = 0
    for _ in range(num_batches):
      batch = next(it)
      n = len(next(iter(batch.values())))
      metrics = ts.eval_step(self.trainer.model, self._device_batch(batch),
                             self.trainer.draws(n))
      values = torch.stack(list(metrics.values())).tolist()   # one transfer
      for name, v in zip(metrics, values):
        sums[name] = sums.get(name, 0.0) + v * n
      count += n
    avg = {k: v / max(count, 1) for k, v in sums.items()}
    for name in self.spec.eval_metrics:
      if name in avg:
        self._logger_for(name, [f'train {name}', f'valid {name}']).add(
            self.step, [avg[name], None] if split_name == 'train'
            else [None, avg[name]])
    return avg

  def run(self):
    """Train to ``num_steps``; returns the model."""
    cfg = self.train_cfg
    start = self.step
    step_time_logger = self._logger_for('step_time', ['step time (ms)'])
    last_log = time.time()
    t_window = time.time()
    window_steps = 0
    while self.step < cfg.num_steps:
      did_cadence = False
      if (cfg.has_valid and cfg.steps_per_valid > 0
          and self.step % cfg.steps_per_valid == 0
          and self.valid_iter is not None):
        self._eval_pass(self.valid_iter,
                        min(cfg.num_batch_valid, 2 if self.step == start
                            else cfg.num_batch_valid), 'valid')
        did_cadence = True
      if cfg.steps_per_trainval > 0 and self.step % cfg.steps_per_trainval == 0:
        self._eval_pass(self.train_iter, 1, 'train')
        did_cadence = True
      if (self.plot_fn is not None and cfg.steps_per_plot > 0
          and self.step % cfg.steps_per_plot == 0):
        self.plot_fn(self)
        did_cadence = True
      if did_cadence:
        # Eval and plot time stay out of the step time.
        t_window = time.time()
        window_steps = 0

      if self.device_train_data is not None:
        idx = torch.from_numpy(self._next_train_idx(cfg.batch_size)).to(
            self.device)
        batch = {k: v.index_select(0, idx)
                 for k, v in self.device_train_data.items()}
      else:
        batch = self._device_batch(next(self.train_iter))
      metrics = self.trainer.train_step(batch)
      window_steps += 1

      # The host waits for the device only here, on the log cadence; the
      # stop at a non-finite loss runs on the same cadence.
      if self.step % cfg.steps_per_log == 0 or self.step >= cfg.num_steps:
        loss = float(metrics['loss'])
        step_ms = (time.time() - t_window) * 1000 / max(window_steps, 1)
        t_window = time.time()
        window_steps = 0
        step_time_logger.add(self.step, step_ms)
        self._logger_for('loss', ['train loss', 'valid loss']).add(
            self.step, [loss, None])
        if time.time() - last_log > 10 or self.step % 100 == 0:
          self.log.info(f'step {self.step} loss {loss:.4f} '
                        f'({step_ms:.0f} ms/step)')
          last_log = time.time()
        if not np.isfinite(loss):
          self.log.error(f'NaN/Inf loss at step {self.step}; stopping')
          break

      if cfg.save_ckpt and self.step % cfg.steps_per_ckpt == 0:
        self.checkpoint()

    if cfg.save_ckpt:
      self.checkpoint()
    for lg in self.loggers.values():
      lg.flush()
    return self.trainer.model

  def checkpoint(self):
    return self.saver.save(convert.checkpoint_leaves(
        self.trainer.model, self.trainer.opt_state), self.step)

  def restore_ckpt(self):
    return self.trainer.restore(self.folder)

  def load_pretrained(self):
    """Start the nets that the config names pretrained ``weights.h5``
    files for (the model family's ``load_pretrained``: JAX
    ``load_pretrained``, ``models/full_model.py:100-121`` and
    ``models/box_model.py:46-62``), before any restore, as JAX does
    (``experiment.py:139-140``)."""
    self.trainer.load_pretrained()

  def close(self):
    """Stop the prefetching threads and write the buffered log rows."""
    for it in (self.train_iter, self.valid_iter):
      if isinstance(it, ConcurrentBatchIterator):
        it.stop()
    for lg in self.loggers.values():
      lg.flush()


# The JAX package's spec names, with each spec's config and the model
# outputs that eval and pack read.
SPECS = {'full': (FullModelConfig, ('y_out', 's_out')),
         'fg': (FGModelConfig, ('y_out', 'd_out'))}


class EvalExperiment:
  """The eval forward of a trained model, on ``device`` (``cuda`` unless
  the caller asks for the CPU).

  ``spec`` is the JAX spec name, 'full' or 'fg'; ``cfg`` (of that spec's
  config class) defaults to the folder's ``model_opt.yaml``.  The full
  model's knob is off, as in the JAX package's eval, and ``glimpse`` is its
  forward's glimpse form: 'kernel' (the hand-written kernels), 'plain'
  (their plain versions, the reference they are held against) or a pair of
  functions.  A pretrained-weights path in the config is not read: the
  checkpoint sets every parameter."""

  def __init__(self, folder, cfg=None, device=None, glimpse='kernel',
               spec='full'):
    if spec not in SPECS:
      raise ValueError(f'spec must be one of {sorted(SPECS)}, got {spec!r}')
    cfg_class, self.output_keys = SPECS[spec]
    if cfg is not None and not isinstance(cfg, cfg_class):
      raise TypeError(f'spec {spec!r} takes a {cfg_class.__name__}, got a '
                      f'{type(cfg).__name__}')
    try:
      path = saver.latest_checkpoint(folder)
    except FileNotFoundError:
      # Eval exists only for trained models: random parameters would give
      # numbers that look like results.
      raise FileNotFoundError(
          f'No ckpt-*.npz under {folder!r}; refusing to eval with randomly '
          'initialised params.') from None
    if cfg is None:
      cfg = cfg_class.from_yaml(os.path.join(folder, 'model_opt.yaml'))
    if spec == 'full':
      cfg = cfg.replace(use_knob=False)
    self.spec = spec
    self.cfg = cfg
    self.model = convert.model_class(cfg)(cfg, device=device)
    self.model.load_state_dict(convert.params_from_checkpoint(path, cfg))
    self.model.eval()
    self.device = self.model.device
    self.step = saver.checkpoint_step(path)
    self.glimpse = glimpse

  def _forward(self, raw):
    x = torch.as_tensor(np.asarray(raw['x'], np.float32)).to(self.device)
    if self.spec == 'fg':
      return fg_model_forward(self.model, x)
    packed = {}
    for src, dst, wanted in zip(('d_out', 'y_out'), ('d_in', 'y_in'),
                                packed_inputs(self.cfg)):
      if wanted:
        if src not in raw:
          raise KeyError(f"the model reads the packed '{src}' and the "
                         'batch has none (see cli.pack.pack_fg)')
        packed[dst] = torch.as_tensor(
            np.asarray(raw[src], np.float32)).to(self.device)
    return full_model_forward(self.model, x, glimpse=self.glimpse, **packed)

  def iterate_split(self, dataset, batch_size):
    """Yields (dataset, raw batch, outputs) over the whole dataset in index
    order; outputs holds the spec's outputs ('y_out' and 's_out' of the
    full model, 'y_out' and 'd_out' of the fg model) where the forward left
    them."""
    n = dataset.get_dataset_size()
    timespan = getattr(self.cfg, 'timespan', None)
    for lo in range(0, n, batch_size):
      raw = dataset.get_batch(np.arange(lo, min(lo + batch_size, n)),
                              timespan=timespan)
      with torch.inference_mode():
        out = self._forward(raw)
      yield dataset, raw, {k: out[k] for k in self.output_keys if k in out}
