"""Per-timestep stop-score diagnostics of a full model over one split.

Counterpart of ``pipelines/count_diag.py:36-123``: the split runs through
the model's eval forward in index order, and only the scores 's_out'
[B, T] come to the host, held against the true counts (the sum of
's_gt').  It reports

  - the score margin at the count boundary: the score of slot K-1, the
    last real object, against slot K, the first empty one, per example;
  - the count accuracy of the scores alone, a slot counting where its
    score passes a threshold, over the grid 0.05, 0.10, ..., 0.95 (the
    first best, so the lowest threshold, wins a tie);
  - at that best threshold, per timestep, the share of real slots that
    miss and of empty slots that fire.

It writes ``count_diag_{split}.json`` and ``count_diag_{split}.csv`` (the
true count and the scores of each example, ``{v:.4f}``) into the model's
folder, the same bytes as the JAX script from the same scores, and prints
the summary's scalars as one JSON line.

    python -m rec_attend_tpu_torch.pipelines.count_diag \\
        --model_id full_model_... [--split valid] [--results results]

It runs on the card; from Python ``main(argv, device='cpu')``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from rec_attend_tpu_torch.cli import args as A
from rec_attend_tpu_torch.data import provider
from rec_attend_tpu_torch.engine.experiment import EvalExperiment

SCORE_GRID = np.round(np.arange(0.05, 0.96, 0.05), 2)


def scores(exp, dataset, batch_size):
  """(s [N, T] float32, the true counts k [N]) of ``dataset`` through the
  ``EvalExperiment`` ``exp``; only 's_out' leaves the device."""
  s_all, k_all = [], []
  for _, raw, outputs in exp.iterate_split(dataset, batch_size,
                                           output_keys=('s_out',)):
    s = outputs['s_out'].cpu().numpy()
    if s.ndim == 3:
      s = s[:, :, 0]
    s_all.append(s)
    k_all.append(np.asarray(raw['s_gt']).sum(axis=1).astype(int))
  return np.concatenate(s_all), np.concatenate(k_all)


def diagnose(s, k, model_id, split):
  """The summary of scores ``s`` [N, T] against true counts ``k`` [N]."""
  n, t = s.shape
  # Boundary margins.
  last_real = s[np.arange(n), np.clip(k - 1, 0, t - 1)]
  first_empty = np.where(k < t, s[np.arange(n), np.clip(k, 0, t - 1)],
                         np.nan)
  margin = last_real - np.where(np.isnan(first_empty), 0.0, first_empty)

  # Mask-free count accuracy over the score-threshold grid.
  rows = []
  for thr in SCORE_GRID:
    count = (s > thr).sum(axis=1)
    rows.append({'thr': float(thr),
                 'count_acc': float((count == k).mean()),
                 'dic_abs': float(np.abs(count - k).mean()),
                 'dic': float((count - k).mean())})
  best = max(rows, key=lambda r: r['count_acc'])

  # Per-timestep miss profile at the best threshold.
  thr = best['thr']
  real = np.arange(t)[None, :] < k[:, None]
  miss_real = ((s <= thr) & real).sum(axis=0) / np.maximum(
      real.sum(axis=0), 1)
  fire_empty = ((s > thr) & ~real).sum(axis=0) / np.maximum(
      (~real).sum(axis=0), 1)
  return {
      'model_id': model_id, 'split': split, 'n': int(n),
      'mean_margin': round(float(np.nanmean(margin)), 4),
      'p10_margin': round(float(np.nanpercentile(margin, 10)), 4),
      'frac_margin_neg': round(float((margin <= 0).mean()), 4),
      'mean_last_real_score': round(float(last_real.mean()), 4),
      'mean_first_empty_score': round(float(np.nanmean(first_empty)), 4),
      'score_only_best': best,
      'score_only_at_0.5': next(r for r in rows if r['thr'] == 0.5),
      'miss_rate_by_t_at_best': [round(float(v), 3) for v in miss_real],
      'false_fire_by_t_at_best': [round(float(v), 3) for v in fire_empty],
      'sweep': rows,
  }


def write(folder, split, summary, s, k):
  """Write ``count_diag_{split}.json`` and ``.csv`` into ``folder``."""
  with open(os.path.join(folder, f'count_diag_{split}.json'), 'w') as f:
    json.dump(summary, f, indent=2)
  with open(os.path.join(folder, f'count_diag_{split}.csv'), 'w') as f:
    f.write('idx,count_gt,' + ','.join(f's{j}' for j in range(s.shape[1]))
            + '\n')
    for i in range(len(s)):
      f.write(f'{i},{k[i]},' + ','.join(f'{v:.4f}' for v in s[i]) + '\n')


def main(argv=None, device=None):
  """Returns the summary written.  ``device`` as the port's other entry
  points take it."""
  p = argparse.ArgumentParser()
  p.add_argument('--model_id', required=True)
  p.add_argument('--results', default='results')
  p.add_argument('--split', default='valid')
  p.add_argument('--batch_size', default=8, type=int)
  p.add_argument('--dataset', default='synth')
  p.add_argument('--dataset_folder', default=None)
  args = p.parse_args(argv)

  restore = os.path.join(args.results, args.model_id)
  data_cfg = A.make_data_config(args, restore=restore)
  exp = EvalExperiment(restore, device=device)
  ds = provider.get(data_cfg.dataset, data_cfg, split=args.split)
  s, k = scores(exp, ds, args.batch_size)
  summary = diagnose(s, k, args.model_id, args.split)
  write(restore, args.split, summary, s, k)
  print(json.dumps({kk: vv for kk, vv in summary.items()
                    if kk not in ('sweep', 'miss_rate_by_t_at_best',
                                  'false_fire_by_t_at_best')}))
  return summary


if __name__ == '__main__':
  main(sys.argv[1:])
