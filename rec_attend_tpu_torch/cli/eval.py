"""The eval command lines: the full model's instance eval and the fg
model's renders.

Counterpart of ``rec_attend_tpu/cli/eval.py``.  ``eval_split``
(``:30-129``) runs the chain confidence (or the explicit score gate) ->
upsample to the labels' full size -> [morph] -> one-label -> threshold
sweep -> [foreground mask, remove-tiny] -> analyzers over one dataset
split, each threshold's analyzers writing their CSVs and, where asked
(the command line's default), its instance renders into ``NN/`` (the
integer percent), the ground truth's into ``gt/``.  The chain runs on the tensors where the forward
left them, on the card or the CPU; the analyzers read host arrays.
``full_main`` is the full model's command line (``:145-199``): a trained
results folder (``--results``/``--model_id``), its ``model_opt.yaml`` and
``data_opt.yaml``, the dataset's splits (``data.provider``) and the
outputs in ``output_<split>`` there; ``--foreground_folder`` names the
fg eval's PNGs of a threshold (``_read_foreground``), which turn on the
dilation, the mask and ``--remove_tiny``.  ``fg_main`` is the fg model's
(``:202-253``): per threshold NN the foreground, resized to each image's
size in the dataset (``orig_size``) before the threshold, as 0/255 PNGs
in ``NN/``, and at the first threshold the orientation's colour wheel
under the model-size foreground in ``orientation/`` and the foreground
target in ``gt/``.

    python -m rec_attend_tpu_torch.cli.eval --model_id <id> \
        --dataset synth --split valid --batch_size 8
    python -m rec_attend_tpu_torch.cli.eval fg --model_id <fg id> \
        --dataset kitti --dataset_folder data/kitti --output out/fg
    python -m rec_attend_tpu_torch.cli.eval --model_id <id> \
        --dataset kitti --dataset_folder data/kitti \
        --foreground_folder out/fg/50 --remove_tiny 100

They run on the card; from Python ``full_main(argv, device='cpu')``.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import sys
import time

import numpy as np
import torch

from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.config import FGModelConfig
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.device import synchronize
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.models.family import get_model_spec
from rec_attend_tpu_torch.utils import logger
from rec_attend_tpu_torch.utils import png
from rec_attend_tpu_torch.utils import postprocess as pp

DEFAULT_ANALYZERS = ['sbd', 'wt_cov', 'unwt_cov', 'avg_fp', 'avg_fn',
                     'avg_pr', 'avg_re', 'obj_pr', 'obj_re', 'count_acc',
                     'count_mse', 'dic', 'dic_abs']


def _clear_stale_csvs(output_folder, analyzer_names):
  # The analyzers of a sweep write {name}_NN.csv: a run with another list
  # of thresholds must not leave older thresholds' files behind.
  for name in analyzer_names:
    for stale in ([os.path.join(output_folder, f'{name}.csv')]
                  + glob.glob(os.path.join(output_folder, f'{name}_*.csv'))):
      if os.path.exists(stale):
        os.remove(stale)


def _analyzer_sets(output_folder, threshold_list, analyzer_names):
  sets = []
  for tt in threshold_list:
    # One threshold writes {name}.csv, a sweep {name}_NN.csv.
    csv_stem = ('{}.csv' if len(threshold_list) == 1 else
                f'{{}}_{int(tt * 100):02d}.csv')
    sets.append([analysis.create_analyzer(
        name, display_name=f'{name} {tt:.2f}',
        fname=os.path.join(output_folder, csv_stem.format(name)))
                 for name in analyzer_names])
  return sets


def eval_split(exp, dataset, output_folder, threshold_list, analyzer_names,
               foreground=None, no_morph=False, remove_tiny=0,
               render_output=False, render_gt=False, batch_size=8,
               score_threshold=None, max_batches=None, timings=None):
  """Run the instance eval chain over ``dataset`` with ``exp``, an
  ``engine.experiment.EvalExperiment``.

  Args:
    foreground: the foreground maps, [H, W] arrays or tensors: one per
      example of the dataset in its index order, or a function
      (dataset, ids) -> a list of the maps of those examples (such as
      ``_read_foreground`` with its folder bound); with them the masks are
      dilated (unless ``no_morph``), masked and cleared of regions of at
      most ``remove_tiny`` pixels.
    render_output: each threshold's instance renders into ``NN/`` (the
      command line's default).
    render_gt: the ground truth's instances, coloured by their best
      match at the last threshold, into ``gt/``.
    score_threshold: the explicit stop gate: slots scored at most this are
      zeroed; None keeps the reference's 0.5-hardened, score-weighted masks.
    max_batches: stop after this many batches.
    timings: a dict that gains, per batch, the host seconds of the forward,
      of the postprocess chain and of the analyzers, the renders included
      ('forward', 'postprocess', 'analyzers' lists), the device
      synchronised between.
  Returns:
    {threshold: {analyzer display name: (mean, std)}}.
  """
  os.makedirs(output_folder, exist_ok=True)
  _clear_stale_csvs(output_folder, analyzer_names)
  analyzer_sets = _analyzer_sets(output_folder, threshold_list,
                                 analyzer_names)
  for tt, analyzers in zip(threshold_list, analyzer_sets):
    if render_output:
      analyzers.append(analysis.RenderInstanceAnalyzer(
          os.path.join(output_folder, f'{int(tt * 100):02d}'), dataset))
  if render_gt:
    analyzer_sets[-1].append(analysis.RenderGroundtruthInstanceAnalyzer(
        os.path.join(output_folder, 'gt'), dataset))
  if timings is not None:
    for key in ('forward', 'postprocess', 'analyzers'):
      timings.setdefault(key, [])
  batches = exp.iterate_split(dataset, batch_size)
  offset = 0
  n_batch = 0
  while max_batches is None or n_batch < max_batches:
    t0 = time.perf_counter()
    try:
      ds, raw, outputs = next(batches)
    except StopIteration:
      break
    n_batch += 1
    y_out, s_out = outputs['y_out'], outputs['s_out']
    synchronize(y_out.device)
    t1 = time.perf_counter()
    idx_map = raw['idx_map']
    y_gt_h = ds.get_full_size_labels(idx_map, timespan=y_out.shape[1])
    fg = None
    if foreground is not None:
      maps = (foreground(ds, idx_map) if callable(foreground) else
              [foreground[offset + i] for i in range(len(idx_map))])
      fg = [torch.as_tensor(m, device=y_out.device, dtype=torch.float32)
            for m in maps]
    offset += len(idx_map)

    if score_threshold is not None:
      # The explicit stop gate: slots under the calibrated score are
      # zeroed, so the count does not hang on the mask threshold.
      y_out, s_out = pp.apply_confidence(y_out, s_out,
                                         threshold=score_threshold)
      y_out = y_out * s_out[:, :, None, None]
    else:
      y_out, s_out = pp.apply_confidence(y_out, s_out)
    y_out = pp.upsample(y_out, [g.shape[-2:] for g in y_gt_h])
    if fg is not None and not no_morph:
      y_out = pp.morph(y_out)
    y_out = pp.apply_one_label(y_out)
    staged = []
    for thresh in threshold_list:
      y_thresh = pp.apply_threshold(y_out, thresh)
      s_thresh = s_out
      if fg is not None:
        y_thresh = pp.mask_foreground(y_thresh, fg)
        y_thresh, s_thresh = pp.remove_tiny(y_thresh, s_thresh,
                                            threshold=remove_tiny)
      staged.append(([y.cpu().numpy() for y in y_thresh],
                     s_thresh.cpu().numpy()))
    t2 = time.perf_counter()
    for (y_host, s_host), analyzers in zip(staged, analyzer_sets):
      results = {
          'y_out': y_host, 'y_gt': y_gt_h, 's_out': s_host,
          's_gt': raw['s_gt'],
          'iou_pairwise': [analysis.f_iou_pairwise(a, b)
                           for a, b in zip(y_host, y_gt_h)],
          'indices': list(idx_map),
      }
      for a in analyzers:
        a.stage(results)
    if timings is not None:
      timings['forward'].append(t1 - t0)
      timings['postprocess'].append(t2 - t1)
      timings['analyzers'].append(time.perf_counter() - t2)

  summary = {}
  for thresh, analyzers in zip(threshold_list, analyzer_sets):
    summary[thresh] = {}
    for a in analyzers:
      r = a.finalize()
      if r is not None:
        summary[thresh][a.name] = r
  return summary


def _read_foreground(folder, dataset, idx_map):
  """The foreground maps of the examples ``idx_map``: each PNG of
  ``folder`` named by the dataset's ``get_fname``, read in colour, its
  largest channel over 255 (a 0/255 render of the fg eval gives 0 and
  1); a missing file raises FileNotFoundError."""
  return [png.imread(os.path.join(folder, dataset.get_fname(ii))).astype(
      'float32').max(axis=2) / 255.0 for ii in idx_map]


def full_main(argv=None, device=None):
  """Evaluate a trained full model over the dataset's splits; returns the
  ``EvalExperiment``.  ``device`` as the port's other entry points take
  it."""
  parser = argparse.ArgumentParser(description='Evaluate full model')
  A.add_eval_args(parser)
  A.add_data_args(parser)
  parser.add_argument('--foreground_folder', default=None)
  parser.add_argument('--threshold_list', default=None)
  parser.add_argument('--analyzers', default=None)
  parser.add_argument('--test', action='store_true')
  parser.add_argument('--no_morph', action='store_true')
  parser.add_argument('--remove_tiny', default=0, type=int)
  parser.add_argument('--score_threshold', default=None, type=float,
                      help='explicit stop-score gate (default: reference '
                           'behaviour — score-weighted masks cut by the '
                           'mask threshold)')
  parser.add_argument('--max_batches', default=None, type=int,
                      help='cap the number of eval batches (threshold '
                           'calibration on the train split)')
  parser.add_argument('--no_render', action='store_true',
                      help='skip instance PNG rendering (calibration '
                           'passes)')
  args = parser.parse_args(argv)
  log = logger.get()
  log.log_args()

  if args.threshold_list is None:
    threshold_list = [0.3]
  else:
    threshold_list = [float(t) for t in args.threshold_list.split(',')]
  if args.analyzers is None:
    analyzer_names = [] if args.test else DEFAULT_ANALYZERS
  else:
    analyzer_names = args.analyzers.split(',') if args.analyzers else []
  foreground = (None if args.foreground_folder is None else
                functools.partial(_read_foreground, args.foreground_folder))

  restore = os.path.join(args.results, args.model_id)
  model_cfg = FullModelConfig.from_yaml(os.path.join(restore,
                                                     'model_opt.yaml'))
  data_cfg = A.make_data_config(args, restore=restore)
  exp = EvalExperiment(restore, cfg=model_cfg, device=device)
  for split in args.split.split(','):
    dataset = provider.get(data_cfg.dataset, data_cfg, split=split)
    out_folder = args.output or os.path.join(restore, f'output_{split}')
    eval_split(exp, dataset, out_folder, threshold_list, analyzer_names,
               foreground=foreground,
               no_morph=args.no_morph, remove_tiny=args.remove_tiny,
               render_output=not args.no_render, batch_size=args.batch_size,
               score_threshold=args.score_threshold,
               max_batches=args.max_batches)
  return exp


def fg_main(argv=None, device=None):
  """Render a trained fg model's foreground, orientation and foreground
  target over the dataset's splits into ``--output`` (default
  ``output/`` in the model's folder); returns the ``EvalExperiment``.
  ``device`` as the port's other entry points take it."""
  parser = argparse.ArgumentParser(description='Evaluate fg model')
  A.add_eval_args(parser)
  A.add_data_args(parser)
  parser.add_argument('--threshold_list', default='0.5')
  args = parser.parse_args(argv)

  restore = os.path.join(args.results, args.model_id)
  model_cfg = FGModelConfig.from_yaml(os.path.join(restore,
                                                   'model_opt.yaml'))
  data_cfg = A.make_data_config(args, restore=restore)
  thresholds = [float(t) for t in args.threshold_list.split(',')]
  exp = EvalExperiment(restore, cfg=model_cfg, device=device, spec='fg')
  variables = set(get_model_spec('fg').batch_variables) | {'idx_map',
                                                           'orig_size'}
  for split in args.split.split(','):
    dataset = provider.get(data_cfg.dataset, data_cfg, split=split)
    out_base = args.output or os.path.join(restore, 'output')
    fg_renders = [analysis.RenderForegroundAnalyzer(
        os.path.join(out_base, f'{int(t * 100):02d}'), dataset)
                  for t in thresholds]
    ori_render = analysis.RenderOrientationAnalyzer(
        os.path.join(out_base, 'orientation'), dataset)
    gt_render = analysis.RenderForegroundAnalyzer(
        os.path.join(out_base, 'gt'), dataset)
    for _, raw, outputs in exp.iterate_split(dataset, args.batch_size,
                                             variables=variables):
      y_out = outputs['y_out']
      y_out = y_out[..., 0] if y_out.shape[-1] == 1 else y_out.amax(-1)
      d_out = outputs.get('d_out')
      indices = list(raw['idx_map'])
      orig = raw.get('orig_size')
      # At each image's size in the dataset, as cv2.resize(INTER_LINEAR).
      sized = [y if orig is None else pp.resize(y, (int(orig[ii][0]),
                                                     int(orig[ii][1])))
               for ii, y in enumerate(y_out)]
      for thresh, render in zip(thresholds, fg_renders):
        render.stage({'y_out': [(y > thresh).float().cpu().numpy()
                                for y in sized], 'indices': indices})
      # At the first threshold, at the model's size.
      if d_out is not None:
        ori_render.stage({
            'd_out': d_out.cpu().numpy(), 'indices': indices,
            'mask': (y_out > thresholds[0]).float().cpu().numpy()})
      if 'c_gt' in raw:
        gt_render.stage({'y_out': np.asarray(raw['c_gt']).max(axis=-1),
                         'indices': indices})
  return exp


MAINS = {'full': full_main, 'fg': fg_main}

if __name__ == '__main__':
  # The fg model's eval takes 'fg' as its first argument; without a model
  # word (or with 'full') the command line is the full model's.
  argv = sys.argv[1:]
  main = MAINS.get(argv[0] if argv else None)
  if main is None:
    full_main(argv)
  else:
    main(argv[1:])
