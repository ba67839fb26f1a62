"""Eval of a trained full model over a dataset split.

Counterpart of ``EvalExperiment`` (``rec_attend_tpu/engine/experiment.py:
452-528``), the full model only: it restores a JAX results folder's latest
``ckpt-*.npz``, refuses a folder without one, and walks a dataset in index
order, unshuffled and without cycling, one eval forward a batch.  The
training loop of that module is ``engine/trainer.py``'s.

    exp = EvalExperiment('results/full_model_synth-20260816104712')
    for dataset, raw, outputs in exp.iterate_split(dataset, 8):
      outputs['y_out']    # [b, T, H, W] on the model's device
      outputs['s_out']    # [b, T]

A dataset is any object with ``get_dataset_size()``,
``get_batch(idx, timespan)`` (a dict with 'x' [b,H,W,3], 's_gt' [b,T] and
'idx_map', the ids) and ``get_full_size_labels(ids, timespan)``;
``data.synthetic.SyntheticDataset`` is one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rec_attend_tpu_torch import convert
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.engine import saver
from rec_attend_tpu_torch.models.full_model import FullModel
from rec_attend_tpu_torch.models.full_model import full_model_forward

OUTPUT_KEYS = ('y_out', 's_out')


class EvalExperiment:
  """The eval forward of a trained full model, on ``device`` (``cuda``
  unless the caller asks for the CPU).

  ``cfg`` defaults to the folder's ``model_opt.yaml``; the knob is off, as
  in the JAX package's eval.  ``glimpse`` is the forward's glimpse form:
  'kernel' (the hand-written kernels), 'plain' (their plain versions, the
  reference they are held against) or a pair of functions."""

  def __init__(self, folder, cfg: FullModelConfig | None = None, device=None,
               glimpse='kernel'):
    try:
      path = saver.latest_checkpoint(folder)
    except FileNotFoundError:
      # Eval exists only for trained models: random parameters would give
      # numbers that look like results.
      raise FileNotFoundError(
          f'No ckpt-*.npz under {folder!r}; refusing to eval with randomly '
          'initialised params.') from None
    if cfg is None:
      cfg = FullModelConfig.from_yaml(os.path.join(folder, 'model_opt.yaml'))
    self.cfg = cfg.replace(use_knob=False)
    self.model = FullModel(self.cfg, device=device)
    self.model.load_state_dict(convert.params_from_checkpoint(path, self.cfg))
    self.model.eval()
    self.device = self.model.device
    self.step = saver.checkpoint_step(path)
    self.glimpse = glimpse

  def iterate_split(self, dataset, batch_size):
    """Yields (dataset, raw batch, outputs) over the whole dataset in index
    order; outputs holds 'y_out' and 's_out' where the forward left them."""
    n = dataset.get_dataset_size()
    for lo in range(0, n, batch_size):
      raw = dataset.get_batch(np.arange(lo, min(lo + batch_size, n)),
                              timespan=self.cfg.timespan)
      x = torch.as_tensor(np.asarray(raw['x'], np.float32))
      with torch.inference_mode():
        out = full_model_forward(self.model, x.to(self.device),
                                 glimpse=self.glimpse)
      yield dataset, raw, {k: out[k] for k in OUTPUT_KEYS}
