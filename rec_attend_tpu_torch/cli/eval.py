"""Instance eval of the full model: the postprocess chain and the analyzers
over one dataset split.

Counterpart of ``eval_split`` and ``DEFAULT_ANALYZERS`` of
``rec_attend_tpu/cli/eval.py:24-129``: confidence (or the explicit score
gate) -> upsample to the labels' full size -> [morph] -> one-label ->
threshold sweep -> [foreground mask, remove-tiny] -> analyzers, each
threshold's analyzers writing their CSVs.  The chain runs on the tensors
where the forward left them, on the card or the CPU; the analyzers read
host arrays.  ``full_main`` is the command line of the full model's eval
(``:145-255``): a trained results folder (``--results``/``--model_id``), its
``model_opt.yaml`` and ``data_opt.yaml``, the dataset's splits
(``data.provider``: synth, CVPPP and KITTI, whose full-size labels
differ in size between images) and the analyzers' CSVs in
``output_<split>`` there.  The foreground PNG reader
(``--foreground_folder``) and the render analyzers are not ported yet
(ROADMAP A.5, the render analyzers).

    python -m rec_attend_tpu_torch.cli.eval --model_id <id> \
        --dataset synth --split valid --batch_size 8
    python -m rec_attend_tpu_torch.cli.eval --model_id <id> \
        --dataset kitti --dataset_folder data/kitti --split valid
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import torch

from rec_attend_tpu_torch import analysis
from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.config import FullModelConfig
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.device import synchronize
from rec_attend_tpu_torch.engine.experiment import EvalExperiment
from rec_attend_tpu_torch.utils import logger
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
               foreground=None, no_morph=False, remove_tiny=0, batch_size=8,
               score_threshold=None, max_batches=None, timings=None):
  """Run the instance eval chain over ``dataset`` with ``exp``, an
  ``engine.experiment.EvalExperiment``.

  Args:
    foreground: one [H, W] foreground map (array or tensor) per example of
      the dataset, in its index order; with it the masks are dilated
      (unless ``no_morph``), masked and cleared of regions of at most
      ``remove_tiny`` pixels.
    score_threshold: the explicit stop gate: slots scored at most this are
      zeroed; None keeps the reference's 0.5-hardened, score-weighted masks.
    max_batches: stop after this many batches.
    timings: a dict that gains, per batch, the host seconds of the forward,
      of the postprocess chain and of the analyzers ('forward',
      'postprocess', 'analyzers' lists), the device synchronised between.
  Returns:
    {threshold: {analyzer display name: (mean, std)}}.
  """
  os.makedirs(output_folder, exist_ok=True)
  _clear_stale_csvs(output_folder, analyzer_names)
  analyzer_sets = _analyzer_sets(output_folder, threshold_list,
                                 analyzer_names)
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
      fg = [torch.as_tensor(foreground[offset + i], device=y_out.device,
                            dtype=torch.float32)
            for i in range(len(idx_map))]
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
  if args.foreground_folder is not None:
    raise NotImplementedError('--foreground_folder: the foreground PNG '
                              'reader is not ported yet (ROADMAP A.5, the '
                              'render analyzers)')
  if not args.no_render:
    log.info('The render analyzers are not ported yet (ROADMAP A.5, the '
             'render analyzers): no PNGs are written')

  if args.threshold_list is None:
    threshold_list = [0.3]
  else:
    threshold_list = [float(t) for t in args.threshold_list.split(',')]
  if args.analyzers is None:
    analyzer_names = [] if args.test else DEFAULT_ANALYZERS
  else:
    analyzer_names = args.analyzers.split(',') if args.analyzers else []

  restore = os.path.join(args.results, args.model_id)
  model_cfg = FullModelConfig.from_yaml(os.path.join(restore,
                                                     'model_opt.yaml'))
  data_cfg = A.make_data_config(args, restore=restore)
  exp = EvalExperiment(restore, cfg=model_cfg, device=device)
  for split in args.split.split(','):
    out_folder = args.output or os.path.join(restore, f'output_{split}')
    dataset = provider.get(data_cfg.dataset, data_cfg, split=split)
    eval_split(exp, dataset, out_folder, threshold_list, analyzer_names,
               no_morph=args.no_morph, remove_tiny=args.remove_tiny,
               batch_size=args.batch_size,
               score_threshold=args.score_threshold,
               max_batches=args.max_batches)
  return exp


if __name__ == '__main__':
  full_main(sys.argv[1:])
