"""Pack the fg model's predictions for the full model, and the full model's
for the Cityscapes eval, in memory.

Counterpart of ``fg_main`` and ``full_main`` of
``rec_attend_tpu/cli/pack.py:26-83``.  The JAX
package writes each example's foreground and orientation maps into the
dataset's H5 file as uint8 PNGs, ``(np.clip(a, 0, 1) * 255).astype('uint8')``
(``data/dataset.py:262-274``, which truncates), and its dataset reads them
back as ``uint8 / 255`` under 'y_out' and 'd_out' (``:235-245``), where the
full model's experiment finds them.  Here the same bytes stay in memory:
``pack_fg`` runs the fg model over a dataset and returns a view of it whose
batches carry the maps that a JAX H5 pack would give back, bit for bit.
``pack_full`` does the same with the full model's instance maps, packed as
uint8 per slot, and its scores, kept as float32 (``data/dataset.py:
264-298``): they come back as 'y_out_ins' and 's_out'.

    fg = EvalExperiment('results/fg_model_synth3-20260818a', spec='fg')
    packed = pack_fg(fg, dataset, 32)
    full = EvalExperiment('results/full_model_synth3-20260818a')
    eval_split(full, packed, ...)
    packed = pack_full(full, packed, 32)   # for cli.cityscapes_eval
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rec_attend_tpu_torch.device import synchronize

# uint8 -> float32 as the JAX dataset reads a packed PNG (a float32 division
# by 255), as a table: the same values on the card and on the host.
_DECODE = np.arange(256, dtype=np.float32) / 255


def quantise(a):
  """[...] float maps -> uint8, ``(clip(a, 0, 1) * 255)`` truncated, as the
  JAX pack writes them.  A float32 product and a truncation: the same bytes
  on the card as on the host."""
  return (torch.clamp(a.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


class PackedDataset:
  """A dataset with packed predictions: its ``get_batch`` adds to the
  underlying dataset's batch the fg model's 'd_out' [b,H,W,8] and 'y_out'
  [b,H,W,C] and, where the full model's are packed, 'y_out_ins' [b,T,H,W]
  (float32, read from the uint8 maps as the JAX dataset does) and 's_out'
  [b,T]."""

  def __init__(self, dataset, d_out, y_out, y_out_ins=None, s_out=None):
    self.dataset = dataset
    self.d_out = d_out            # [N,H,W,8] uint8, in the dataset's order
    self.y_out = y_out            # [N,H,W,C] uint8
    self.y_out_ins = y_out_ins    # [N,T,H,W] uint8 or None
    self.s_out = s_out            # [N,T] float32 or None

  def get_dataset_size(self):
    return self.dataset.get_dataset_size()

  def get_batch(self, idx, timespan=None):
    idx = np.asarray(idx)
    batch = dict(self.dataset.get_batch(idx, timespan=timespan))
    batch['d_out'] = _DECODE[self.d_out[idx]]
    batch['y_out'] = _DECODE[self.y_out[idx]]
    if self.y_out_ins is not None:
      batch['y_out_ins'] = _DECODE[self.y_out_ins[idx]]
      batch['s_out'] = self.s_out[idx]
    return batch

  def get_full_size_labels(self, ids, timespan=None):
    return self.dataset.get_full_size_labels(ids, timespan=timespan)


def pack_fg(fg_experiment, dataset, batch_size, timings=None):
  """Run the fg model of ``fg_experiment`` (an ``EvalExperiment`` of spec
  'fg' with the orientation head) over ``dataset`` in index order, quantise
  its predictions where it runs, and return a ``PackedDataset``.

  ``timings``: a dict that gains, per batch, the host seconds of the
  forward and of the pack (quantisation and copy to the host), the device
  synchronised between ('forward', 'pack' lists)."""
  if fg_experiment.spec != 'fg' or not fg_experiment.cfg.add_orientation:
    raise ValueError('pack_fg takes the fg model with its orientation head')
  if timings is not None:
    for key in ('forward', 'pack'):
      timings.setdefault(key, [])
  d_out, y_out = [], []
  batches = fg_experiment.iterate_split(dataset, batch_size)
  while True:
    t0 = time.perf_counter()
    try:
      _, _, outputs = next(batches)
    except StopIteration:
      break
    synchronize(fg_experiment.device)
    t1 = time.perf_counter()
    d_out.append(quantise(outputs['d_out']).cpu().numpy())
    y_out.append(quantise(outputs['y_out']).cpu().numpy())
    if timings is not None:
      timings['forward'].append(t1 - t0)
      timings['pack'].append(time.perf_counter() - t1)
  return PackedDataset(dataset, np.concatenate(d_out), np.concatenate(y_out))


def pack_full(full_experiment, dataset, batch_size, timings=None):
  """Run the full model of ``full_experiment`` (an ``EvalExperiment`` of
  spec 'full') over ``dataset``, a ``PackedDataset`` of ``pack_fg``, in
  index order, quantise its instance maps where it runs, keep its scores
  as float32, and return a ``PackedDataset`` that carries them beside the
  fg model's maps.  ``timings`` as in ``pack_fg``."""
  if full_experiment.spec != 'full':
    raise ValueError('pack_full takes the full model')
  if not isinstance(dataset, PackedDataset):
    raise TypeError('pack_full takes the PackedDataset of pack_fg')
  if timings is not None:
    for key in ('forward', 'pack'):
      timings.setdefault(key, [])
  y_out_ins, s_out = [], []
  batches = full_experiment.iterate_split(dataset, batch_size)
  while True:
    t0 = time.perf_counter()
    try:
      _, _, outputs = next(batches)
    except StopIteration:
      break
    synchronize(full_experiment.device)
    t1 = time.perf_counter()
    y_out_ins.append(quantise(outputs['y_out']).cpu().numpy())
    s_out.append(outputs['s_out'].float().cpu().numpy())
    if timings is not None:
      timings['forward'].append(t1 - t0)
      timings['pack'].append(time.perf_counter() - t1)
  return PackedDataset(dataset.dataset, dataset.d_out, dataset.y_out,
                       np.concatenate(y_out_ins), np.concatenate(s_out))
