"""Pack the fg model's predictions for the box and the full model, and the
full model's for the Cityscapes eval.

Counterpart of ``fg_main`` and ``full_main`` of
``rec_attend_tpu/cli/pack.py:26-83``.  The JAX
package writes each example's foreground and orientation maps into the
dataset's H5 file as uint8 PNGs, ``(np.clip(a, 0, 1) * 255).astype('uint8')``
(``data/dataset.py:262-274``, which truncates), and its dataset reads them
back as ``uint8 / 255`` under 'y_out' and 'd_out' (``:235-245``), where the
box and the full model's experiments find them.  ``pack_fg`` runs the fg
model over a dataset and returns a ``data.provider.PackedDataset`` whose
batches carry the maps that a JAX H5 pack would give back, bit for bit;
``fg_main``, the command line, writes those bytes into each split's pack
file (``data.provider.write_pack``), where ``provider.get`` finds them in
any later process.  ``pack_full`` does the same in memory with the full
model's instance maps, packed as uint8 per slot, and its scores, kept as
float32 (``data/dataset.py:264-298``): they come back as 'y_out_ins' and
's_out'; ``full_main``, its command line, writes them into the split's
pack file beside the fg model's maps.

    python -m rec_attend_tpu_torch.cli.pack --model_id <fg model id> \\
        --dataset synth --split train,valid --batch_size 8
    python -m rec_attend_tpu_torch.cli.pack full --model_id <full model id> \\
        --dataset synth --split valid --batch_size 4

    fg = EvalExperiment('results/fg_model_synth3-20260818a', spec='fg')
    packed = pack_fg(fg, dataset, 32)
    full = EvalExperiment('results/full_model_synth3-20260818a')
    eval_split(full, packed, ...)
    packed = pack_full(full, packed, 32)   # for cli.cityscapes_eval
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.data.provider import PackedDataset
from rec_attend_tpu_torch.device import synchronize
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.utils import logger


def quantise(a):
  """[...] float maps -> uint8, ``(clip(a, 0, 1) * 255)`` truncated, as the
  JAX pack writes them.  A float32 product and a truncation: the same bytes
  on the card as on the host."""
  return (torch.clamp(a.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


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


def _parse(description, argv):
  parser = argparse.ArgumentParser(description=description)
  A.add_eval_args(parser)
  A.add_data_args(parser)
  return parser.parse_args(argv)


def fg_main(argv=None, device=None):
  """The pack command line (JAX ``cli/pack.py:26-55``): the fg model of
  ``--results``/``--model_id`` over each split of ``--split``, its maps
  written into the split's pack file.  Returns {split: (path, bytes)}.
  ``device`` as the port's other entry points take it.

  The file is written anew with the fg model's maps only: the full model's
  maps that ``full_main`` packed beside them came from a model fed the old
  maps, so a re-pack drops them (run ``full_main`` again)."""
  args = _parse('Pack fg model output', argv)
  log = logger.get()
  restore = os.path.join(args.results, args.model_id)
  model_cfg = FGModelConfig.from_yaml(os.path.join(restore,
                                                   'model_opt.yaml'))
  data_cfg = A.make_data_config(args, restore=restore)
  exp = EvalExperiment(restore, cfg=model_cfg, device=device, spec='fg')
  written = {}
  for split in args.split.split(','):
    ds = provider.get(data_cfg.dataset, data_cfg, split=split)
    packed = pack_fg(exp, ds, args.batch_size)
    ids = getattr(ds, 'dataset', ds).img_ids
    path = provider.pack_path(data_cfg, split)
    nbytes = provider.write_pack(path, ids, packed.d_out, packed.y_out,
                                 provider.settings(data_cfg, split))
    written[split] = (path, nbytes)
    log.info(f'Packed fg predictions into {path} ({split})')
  return written


def full_main(argv=None, device=None):
  """The full model's pack command line (JAX ``cli/pack.py:57-83``): the
  full model of ``--results``/``--model_id``, its knob off, over each split
  of ``--split`` as ``pack_fg`` left it in the split's pack file, its
  instance maps and scores written into that file beside the fg model's
  maps.  Returns {split: (path, bytes)}; ``device`` as ``fg_main``."""
  args = _parse('Pack full model output', argv)
  log = logger.get()
  restore = os.path.join(args.results, args.model_id)
  model_cfg = FullModelConfig.from_yaml(os.path.join(restore,
                                                     'model_opt.yaml'))
  data_cfg = A.make_data_config(args, restore=restore)
  exp = EvalExperiment(restore, cfg=model_cfg, device=device)
  written = {}
  for split in args.split.split(','):
    ds = provider.get(data_cfg.dataset, data_cfg, split=split)
    if not isinstance(ds, PackedDataset):
      raise FileNotFoundError(
          f'no pack file of the fg model for the {split!r} split at '
          f'{provider.pack_path(data_cfg, split)}: run the fg pack first')
    packed = pack_full(exp, ds, args.batch_size)
    path = provider.pack_path(data_cfg, split)
    nbytes = provider.write_pack(
        path, ds.dataset.img_ids, packed.d_out, packed.y_out,
        provider.settings(data_cfg, split), y_out_ins=packed.y_out_ins,
        s_out=packed.s_out)
    written[split] = (path, nbytes)
    log.info(f'Packed instance predictions into {path} ({split})')
  return written


if __name__ == '__main__':
  if sys.argv[1:2] == ['full']:
    full_main(sys.argv[2:])
  else:
    fg_main(sys.argv[1:])
