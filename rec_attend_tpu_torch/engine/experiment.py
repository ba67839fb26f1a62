"""Eval of a trained full or fg model over a dataset split.

Counterpart of ``EvalExperiment`` (``rec_attend_tpu/engine/experiment.py:
452-528``) with the ``full`` and ``fg`` model specs (``:58-100``): it
restores a JAX results folder's latest ``ckpt-*.npz``, refuses a folder
without one, and walks a dataset in index order, unshuffled and without
cycling, one eval forward a batch.  The training loop of that module is
``engine/trainer.py``'s.

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

import os

import numpy as np
import torch

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models.fg_model import fg_model_forward
from rec_attend_tpu_torch.models.full_model import full_model_forward
from rec_attend_tpu_torch.models.full_model import packed_inputs

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
