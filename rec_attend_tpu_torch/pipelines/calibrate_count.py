"""The calibrated stop score and mask threshold of a full model, both
picked on the train split.

Counterpart of ``pipelines/calibrate_count.py:28-110``, in three steps:
  1. ``count_diag`` on the train split: the stop-score threshold of the
     best train count accuracy (scores alone, no masks);
  2. the eval command line on the valid split with that threshold as the
     explicit stop gate (``--score_threshold``), over the mask-threshold
     sweep, into ``output_valid_calibrated/``;
  3. the same on a capped train prefix (``--max_batches 32 --no_render``)
     into ``output_train_calibrated/``: the mask threshold of the best
     train SBD.
Then ``count_calibration.json``: the before/after rows (the reference row
reads the model's existing ``output_valid/``, its best mask threshold by
valid SBD) and the headline, the valid split at the mask threshold picked
on the train split (the nearest swept one) and the calibrated stop score.

It writes into the model's results folder.

    python -m rec_attend_tpu_torch.pipelines.calibrate_count \\
        --model_id full_model_... [--results results] [--batch_size 8]

It runs on the card; from Python ``main(argv, device='cpu')``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from rec_attend_tpu_torch.cli import eval as eval_cli
from rec_attend_tpu_torch.pipelines import count_diag
from rec_attend_tpu_torch.pipelines.write_results import best_threshold
from rec_attend_tpu_torch.pipelines.write_results import read_analyzer_csvs
from rec_attend_tpu_torch.pipelines.write_results import split_sweep

TRAIN_MAX_BATCHES = 32
ROW_KEYS = ('sbd', 'count_acc', 'dic_abs', 'count_mse', '_best_mask_thr')


def summary_rows(valid_folders):
  """{label: {metric: mean}} of the eval folders ``valid_folders`` (label
  -> folder), each at its best mask threshold by SBD where it holds a
  sweep."""
  rows = {}
  for label, folder in valid_folders.items():
    metrics, sweep = split_sweep(read_analyzer_csvs(folder))
    if sweep:
      bt = best_threshold(sweep)
      metrics = dict(sweep[bt])
      metrics['_best_mask_thr'] = (bt, 0)
    rows[label] = {k: round(v[0], 4) for k, v in metrics.items()
                   if k in ROW_KEYS}
  return rows


def headline(train_folder, valid_folder, score_threshold):
  """The valid split's metrics at the mask threshold of the best train SBD
  (the nearest swept valid threshold), or None without both sweeps."""
  _, train_sweep = split_sweep(read_analyzer_csvs(train_folder))
  _, valid_sweep = split_sweep(read_analyzer_csvs(valid_folder))
  if not (train_sweep and valid_sweep):
    return None
  bt_train = best_threshold(train_sweep)
  vt = min(valid_sweep, key=lambda t: abs(t - bt_train))
  return {'mask_threshold': bt_train, 'score_threshold': score_threshold,
          'metrics': {k: [round(valid_sweep[vt][k][0], 4),
                          round(valid_sweep[vt][k][1], 4)]
                      for k in sorted(valid_sweep[vt])}}


def main(argv=None, device=None, timings=None):
  """Returns the summary written to ``count_calibration.json``.  ``device``
  as the port's other entry points take it; ``timings``, a dict, gains
  the host seconds of each step ('count_diag', 'valid_eval',
  'train_sweep', 'json')."""
  p = argparse.ArgumentParser()
  p.add_argument('--model_id', required=True)
  p.add_argument('--results', default='results')
  p.add_argument('--batch_size', default=8, type=int)
  p.add_argument('--dataset', default='synth')
  p.add_argument('--dataset_folder', default=None)
  p.add_argument('--threshold_list', default='0.2,0.3,0.4,0.5,0.6,0.7')
  args = p.parse_args(argv)
  restore = os.path.join(args.results, args.model_id)
  timings = {} if timings is None else timings

  common = ['--model_id', args.model_id, '--results', args.results,
            '--batch_size', str(args.batch_size),
            '--dataset', args.dataset]
  if args.dataset_folder:
    common += ['--dataset_folder', args.dataset_folder]

  # 1. The stop score, on the train split.
  t0 = time.perf_counter()
  train_summary = count_diag.main(common + ['--split', 'train'],
                                  device=device)
  thr = train_summary['score_only_best']['thr']
  print(f'calibrated stop-score threshold (train): {thr}')
  timings['count_diag'] = time.perf_counter() - t0

  # 2. The valid split with the calibrated gate, beside output_valid/.
  t0 = time.perf_counter()
  out_folder = os.path.join(restore, 'output_valid_calibrated')
  eval_cli.full_main(common + [
      '--split', 'valid', '--output', out_folder,
      '--threshold_list', args.threshold_list,
      '--score_threshold', str(thr)], device=device)
  timings['valid_eval'] = time.perf_counter() - t0

  # 3. The mask threshold, on a capped train prefix with the same gate.
  t0 = time.perf_counter()
  train_out = os.path.join(restore, 'output_train_calibrated')
  eval_cli.full_main(common + [
      '--split', 'train', '--output', train_out,
      '--threshold_list', args.threshold_list,
      '--score_threshold', str(thr),
      '--max_batches', str(TRAIN_MAX_BATCHES), '--no_render'],
                     device=device)
  timings['train_sweep'] = time.perf_counter() - t0

  t0 = time.perf_counter()
  rows = summary_rows({'reference(0.5-weighted)': os.path.join(
      restore, 'output_valid'), f'calibrated({thr})': out_folder})
  summary = {'model_id': args.model_id, 'calibrated_threshold': thr,
             'train_score_only': train_summary['score_only_best'],
             'headline': headline(train_out, out_folder, thr),
             'valid': rows}
  with open(os.path.join(restore, 'count_calibration.json'), 'w') as f:
    json.dump(summary, f, indent=2)
  print(json.dumps(summary, indent=2))
  timings['json'] = time.perf_counter() - t0
  return summary


if __name__ == '__main__':
  main(sys.argv[1:])
